"""Factory-string parser: FAISS index_factory grammar → index model graph.

The reference forwards the index-type string straight to
``faiss::index_factory(dim, desc, metric)`` (src/faiss_extension.cpp:154-155),
so the observable surface is the factory grammar itself:

    desc        := [prefix ","]* [transform ","]* component ["," encoding]
                   ["," suffix]
    prefix      := "IDMap" | "IDMap2"
    transform   := "PCA"[R|W]n | "OPQ"m["_"dout] | "RR"[n] | "ITQ"[n] | "Pad"n
                   | "L2norm"
    component   := "Flat" | "HNSW"[M] | "NSG"[R] | "IVF"nlist["_" quantizer]
                   | "IVF"nlist"("quantizer-desc")"   (parenthesized form)
                   | "IMI2x"nbits (product coarse quantizer, nlist=4^nbits)
                   | "PQ"M["x"nbits] | "RQ"M"x"nbits | "LSH"[nbits]["r"]["t"]
                   | "SQ8" | "SQ4" | "SQ6" | "SQfp16" | "SQbf16"
    quantizer   := "Flat" | "HNSW"[M] | "PQ"M
    encoding    := "Flat" | "PQ"M["x"nbits] | "RQ"M"x"nbits | "SQ8"
                   | "SQ4" | "SQ6" | "SQfp16" | "SQbf16"
    suffix      := "RFlat"  (exact re-rank wrapper, IndexRefineFlat)

The whole grammar is parsed, with the same parse errors as the JAX
package.  ``Flat``, ``PQm[xb]``, ``RQMxb``, ``IVFn[_Flat][,Flat]``,
``IVFn[_Flat],SQ8`` / ``SQ4`` / ``SQ6`` and ``IVFn[_Flat],PQm[xb]`` /
``RQMxb`` under any number of IDMap prefixes build; every other family
(standalone ``SQ*``, HNSW, NSG, IMI, LSH), quantizer (HNSW, the
parenthesized form), encoding (``SQfp16``, ``SQbf16``), transform or suffix
(``RFlat``) raises ``InvalidInputError`` naming it as not yet available in
this package, so a description never builds something other than what it
says.
"""

from __future__ import annotations

import re

from .errors import InvalidInputError
from .metrics import Metric
from .models.base import Index
from .models.flat import FlatIndex
from .models.idmap import IDMapIndex

_HNSW_RE = re.compile(r"^HNSW(\d*)$")
_IVF_RE = re.compile(r"^IVF(\d+)(?:_(.+))?$")
_IVF_PAREN_RE = re.compile(r"^IVF(\d+)\((.+)\)$")
_PQ_RE = re.compile(r"^PQ(\d+)(?:x(\d+))?$")
_SQ_RE = re.compile(r"^SQ(8|4|6|fp16|bf16)$")
_LSH_RE = re.compile(r"^LSH(\d*)(r?)(t?)$")
_PCA_RE = re.compile(r"^PCA(R|W)?(\d+)$")
_OPQ_RE = re.compile(r"^OPQ(\d+)(?:_(\d+))?$")
_RR_RE = re.compile(r"^RR(\d*)$")
_ITQ_RE = re.compile(r"^ITQ(\d*)$")
_PAD_RE = re.compile(r"^Pad(\d+)$")
_NSG_RE = re.compile(r"^NSG(\d*)$")
_IMI_RE = re.compile(r"^IMI2x(\d+)$")
_RQ_RE = re.compile(r"^RQ(\d+)x(\d+)$")

_TRANSFORM_RES = (_PCA_RE, _OPQ_RE, _RR_RE, _ITQ_RE, _PAD_RE)
_SQ_TYPES = ("SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16")


def _is_transform(tok: str) -> bool:
    """Transform-prefix tokens (faiss VectorTransform grammar subset)."""
    return tok == "L2norm" or any(r.match(tok) for r in _TRANSFORM_RES)


def _parse_error(desc: str, detail: str = "") -> InvalidInputError:
    extra = f" ({detail})" if detail else ""
    return InvalidInputError(f"could not parse index string {desc}{extra}")


def _not_available(desc: str, what: str) -> InvalidInputError:
    return InvalidInputError(
        f"index string {desc}: {what} is not yet available in "
        f"duckdb_faiss_ext_tpu_torch")


def _split_components(desc: str) -> list[str]:
    """Split a factory description on top-level commas, respecting the
    parenthesized coarse-quantizer form (``IVF4096(IVF256,Flat),PQ8``)."""
    parts, depth, cur = [], 0, []
    for ch in desc:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise _parse_error(desc, "unbalanced parentheses")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise _parse_error(desc, "unbalanced parentheses")
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _parse(desc: str):
    """Validate ``desc`` against the grammar.  Returns (idmap prefixes,
    transform tokens, refine suffix, component parts)."""
    parts = _split_components(desc)
    if not parts:
        raise _parse_error(desc, "empty description")

    idmap = 0
    while parts and parts[0] in ("IDMap", "IDMap2"):
        idmap += 1
        parts.pop(0)
    if not parts:
        raise _parse_error(desc, "no index component after IDMap")

    refine = False
    if parts[-1] == "RFlat":
        refine = True
        parts.pop()
        if not parts:
            raise _parse_error(desc, "RFlat needs a base index")

    transforms = []
    while parts and _is_transform(parts[0]):
        transforms.append(parts.pop(0))
    if not parts:
        raise _parse_error(desc, "no index component after transforms")

    _check_component(parts, desc)
    return idmap, transforms, refine, parts


def _check_component(parts, desc) -> str:
    """Grammar check of the component and its encoding; returns the
    component's family name."""
    head = parts[0]
    rest = parts[1:]

    if head == "Flat":
        if rest:
            raise _parse_error(desc, f"unexpected trailing components {rest}")
        return "Flat"

    for regex, family in ((_HNSW_RE, "HNSW"), (_NSG_RE, "NSG")):
        if regex.match(head):
            if rest and rest[0] not in ("Flat",) and not _PQ_RE.match(rest[0]) \
                    and not _SQ_RE.match(rest[0]):
                raise _parse_error(desc,
                                   f"unsupported {family} storage {rest[0]}")
            if len(rest) > 1:
                raise _parse_error(desc,
                                   f"unexpected trailing components {rest[1:]}")
            return family

    m = _IVF_PAREN_RE.match(head) or _IVF_RE.match(head)
    if m:
        _parse(m.group(2) or "Flat")     # the coarse quantizer's own grammar
        if len(rest) > 1:
            raise _parse_error(desc, f"unexpected trailing components {rest[1:]}")
        return "IVF"

    if _IMI_RE.match(head):
        if len(rest) > 1:
            raise _parse_error(desc, f"unexpected trailing components {rest[1:]}")
        return "IMI"

    for regex, family in ((_PQ_RE, "PQ"), (_RQ_RE, "RQ"), (_LSH_RE, "LSH")):
        if regex.match(head):
            if rest:
                raise _parse_error(desc, f"unexpected trailing components {rest}")
            return family

    if head in _SQ_TYPES:
        if rest:
            raise _parse_error(desc, f"unexpected trailing components {rest}")
        return "SQ"

    raise _parse_error(desc, f"unknown component {head}")


def _build_ivf(d, parts, metric, metric_arg, desc) -> Index:
    """``IVFn[_Flat][,Flat]``, ``IVFn[_Flat],SQ{8,4,6}`` and
    ``IVFn[_Flat],PQm[xb]`` / ``RQMxb``: inverted lists over a Flat coarse
    quantizer (the reference's graph shape)."""
    from .models.ivf import SQ_ENCODINGS, IVFIndex

    if _IVF_PAREN_RE.match(parts[0]):
        raise _not_available(desc, "the parenthesized IVF quantizer")
    m = _IVF_RE.match(parts[0])
    if m.group(2) not in (None, "Flat"):
        raise _not_available(desc, f"IVF quantizer {m.group(2)}")
    encoding = parts[1] if len(parts) > 1 else "Flat"
    if (encoding != "Flat" and encoding not in SQ_ENCODINGS
            and not _PQ_RE.match(encoding) and not _RQ_RE.match(encoding)):
        raise _not_available(desc, f"IVF encoding {encoding}")
    return IVFIndex(d, metric, metric_arg, nlist=int(m.group(1)),
                    quantizer=FlatIndex(d, metric, metric_arg),
                    encoding=encoding)


def build_index(d: int, desc: str, metric: Metric,
                metric_arg: float = 0.0) -> Index:
    """Build the index graph for a factory description."""
    idmap, transforms, refine, parts = _parse(desc)
    if transforms:
        raise _not_available(desc, f"transform {transforms[0]}")
    if refine:
        raise _not_available(desc, "RFlat")
    family = _check_component(parts, desc)
    if family == "Flat":
        index: Index = FlatIndex(d, metric, metric_arg)
    elif family == "IVF":
        index = _build_ivf(d, parts, metric, metric_arg, desc)
    elif family == "PQ":
        from .models.pq import PQIndex

        m = _PQ_RE.match(parts[0])
        index = PQIndex(d, metric, metric_arg, M=int(m.group(1)),
                        nbits=int(m.group(2)) if m.group(2) else 8)
    elif family == "RQ":
        from .models.rq import RQIndex

        m = _RQ_RE.match(parts[0])
        index = RQIndex(d, metric, metric_arg, M=int(m.group(1)),
                        nbits=int(m.group(2)))
    else:
        raise _not_available(desc, family)
    if idmap:
        index = IDMapIndex(index)
    index.factory_desc = desc
    return index
