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

The whole grammar is parsed and built, with the same parse errors as the
JAX package: ``Flat``, ``HNSW[M]`` and ``NSG[R]`` with their storage label
(models/hnsw.py), ``PQm[xb]``, ``RQMxb``, ``SQ8`` / ``SQ4`` / ``SQ6`` /
``SQfp16`` / ``SQbf16``, ``LSH[n][r][t]``, ``IVFn`` with any coarse
quantizer (``IVFn_HNSWm``, ``IVFn_PQm`` and the parenthesized form build
the quantizer through ``build_index``) and ``IMI2xn``, each with a Flat,
SQ, PQ or RQ encoding, every transform prefix (models/pretransform.py over
transforms.py) and the ``RFlat`` suffix (models/refine.py), under any
number of IDMap prefixes, as the graph IDMap → RFlat → PreTransform →
component (the JAX package's order).
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


def _build_transform(tok: str, d: int):
    """The transform of a prefix token at input dimension d: PCAn / PCARn /
    PCAWn, OPQm[_dout], RR[n], ITQ[n], Padn, L2norm."""
    from .transforms import (ITQTransform, L2NormTransform, OPQMatrix,
                             PadTransform, PCAMatrix, RandomRotationMatrix)

    if tok == "L2norm":
        return L2NormTransform(d)
    m = _PCA_RE.match(tok)
    if m:
        return PCAMatrix(d, int(m.group(2)),
                         random_rotation=m.group(1) == "R",
                         whiten=m.group(1) == "W")
    m = _OPQ_RE.match(tok)
    if m:
        return OPQMatrix(d, int(m.group(1)),
                         int(m.group(2)) if m.group(2) else None)
    m = _RR_RE.match(tok)
    if m:
        return RandomRotationMatrix(d, int(m.group(1)) if m.group(1)
                                    else None)
    m = _ITQ_RE.match(tok)
    if m:
        return ITQTransform(d, int(m.group(1)) if m.group(1) else None)
    return PadTransform(d, int(_PAD_RE.match(tok).group(1)))


def _parse_error(desc: str, detail: str = "") -> InvalidInputError:
    extra = f" ({detail})" if detail else ""
    return InvalidInputError(f"could not parse index string {desc}{extra}")


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


def _build_ivf(d, parts, metric, metric_arg, family) -> Index:
    """``IVFn[_quantizer]``, ``IVFn(quantizer-desc)`` or ``IMI2xn`` heads
    with a Flat, SQ{8,4,6,fp16,bf16}, PQm[xb] or RQMxb encoding: inverted
    lists over the coarse quantizer the description names (a Flat one by
    default), or over the product quantizer."""
    from .models.ivf import IVFIndex

    encoding = parts[1] if len(parts) > 1 else "Flat"
    if family == "IMI":
        from .models.imi import IMIIndex

        return IMIIndex(d, metric, metric_arg,
                        nbits=int(_IMI_RE.match(parts[0]).group(1)),
                        quantizer=FlatIndex(d, metric, metric_arg),
                        encoding=encoding)
    m = _IVF_PAREN_RE.match(parts[0]) or _IVF_RE.match(parts[0])
    quantizer = build_index(d, m.group(2) or "Flat", metric, metric_arg)
    return IVFIndex(d, metric, metric_arg, nlist=int(m.group(1)),
                    quantizer=quantizer, encoding=encoding)


def build_index(d: int, desc: str, metric: Metric,
                metric_arg: float = 0.0) -> Index:
    """Build the index graph for a factory description."""
    idmap, tokens, refine, parts = _parse(desc)
    family = _check_component(parts, desc)
    transforms, d_cur = [], d
    for tok in tokens:
        transforms.append(_build_transform(tok, d_cur))
        d_cur = transforms[-1].d_out
    index = _build_component(d_cur, parts, metric, metric_arg, family)
    if transforms:
        from .models.pretransform import PreTransformIndex

        index = PreTransformIndex(transforms, index)
    if refine:
        from .models.refine import RefineFlatIndex

        index = RefineFlatIndex(index)
    if idmap:
        index = IDMapIndex(index)
    index.factory_desc = desc
    return index


def _build_component(d, parts, metric, metric_arg, family) -> Index:
    if family == "Flat":
        index: Index = FlatIndex(d, metric, metric_arg)
    elif family in ("IVF", "IMI"):
        index = _build_ivf(d, parts, metric, metric_arg, family)
    elif family in ("HNSW", "NSG"):
        from .models.hnsw import HNSWIndex, NSGIndex

        m = (_HNSW_RE if family == "HNSW" else _NSG_RE).match(parts[0])
        index = (HNSWIndex if family == "HNSW" else NSGIndex)(
            d, metric, metric_arg, M=int(m.group(1) or 32),
            storage_label=parts[1] if len(parts) > 1 else "Flat")
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
    elif family == "SQ":
        from .models.sq import SQIndex

        index = SQIndex(d, metric, metric_arg, qtype=parts[0])
    else:
        from .models.lsh import LSHIndex

        m = _LSH_RE.match(parts[0])
        index = LSHIndex(d, metric, metric_arg,
                         nbits=int(m.group(1)) if m.group(1) else None,
                         rotate=bool(m.group(2)),
                         train_thresholds=bool(m.group(3)))
    return index
