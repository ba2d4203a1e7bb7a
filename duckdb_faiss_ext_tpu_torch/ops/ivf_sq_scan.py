"""Per-query IVF,SQ8/SQ4/SQ6 int8 list search (K2): the hand-written CUDA
kernels ``csrc/ivf_sq_scan.cu``, their wrappers, their plain torch
versions, and the exact rerank every int8 list scan ends in.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
_sq_scan_kernel`` together with what its wrapper ``pallas_ivf_sq_search``
ran around it: the top ``k_scan`` of the int8 scores, ``sq_exact_rerank``
(decode the selected rows, score them in fp32, keep the best k) and the
position resolve.  Codes are stored padded as (nlist, lmax, w) uint8
packed rows, with the per-slot Σ(scale·c)² (``rn``) and Σc (``rs``) beside
them (models/ivf_layout.py); a live slot's int8 score is the formula of
ops/sq_digits.py.

Two designs:

* ``ivf_sq_list_search`` for k_scan ≤ ``MAX_K`` (1024): the fused search,
  two launches in one C call over one workspace (``TopKLaunch``), on the
  skeleton of ``csrc/list_topk.cuh`` (host side ops/list_topk.py): a
  partial launch over queries x splits (equal shares of a query's row
  chunks) streams each probed list's live code rows through shared memory
  (TMA bulk copies from a producer warp) to consumer warps that score them
  with ``__dp4a`` int32 digit dots (csrc/sq_digits.cuh, 8 lanes a row)
  and keep the best k_scan
  (score, flat index) a warp; a merge launch, a block a query, merges the
  splits' lists into the k_scan candidates, equal bit for bit to the plain
  ``exact_topk`` of the raw scores, then rescores each from the padded
  codes in fp32 (K5's decode, the sum in dimension order), keeps the best
  k and resolves positions.  No score block is written, and
  ``sq_exact_rerank`` stays as the plain oracle only.
* ``ivf_sq_scan``, the raw launch: the int8 scores of all lmax slots of
  every (query, probed list), -inf where a slot is not live.  Above
  ``MAX_K`` the search takes it with the torch top-k_scan and
  ``sq_exact_rerank`` (a stated route); the tests and ``chip_smoke.py``
  use it, and it is the fused search's "before" when the two are timed in
  turns.

What bounds it on the H100: the probed lists' code bytes with their rn /
rs, each read once (count x (w + 8) a distinct probed list); the raw
launch also writes the (nq, nprobe, lmax) score block.

The wrappers launch the kernels for CUDA tensors and raise on what the
kernels do not take; they take the plain versions only for CPU tensors.
``walk`` is the plain version of the fused search's own algorithm (the
plan's splits and warps, the merge, the rescore).
"""

from __future__ import annotations

import torch

from ..utils.config import full_fp32
from . import list_topk as lt
from .flat_search import exact_topk
from .ivf_list_scan import expect
from .sq import sq_decode
from .sq_digits import (CODEC_ID, KERNEL_SHIFT, METRICS, digit_dots,
                        digit_width, int8_scores, query_digits)

#: launches of the raw CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0
#: fused searches launched on the card since import (or since a caller
#: reset it): one for each ``TopKLaunch.run`` of both launches
TOPK_LAUNCHES = 0
MAX_K = lt.MAX_K
#: warps of a merge block: a thread rescores a candidate
MERGE_WARPS = 4

_NEG_INF = float("-inf")

#: bytes a VEC unit of the kernels reads (rows must be whole units)
VEC_BYTES = {"sq8": 16, "sq4": 16, "sq6": 48}


def check_sq_lists(fn, codes, rn, rs, counts, mask, metric, codec):
    """Checks shared by the K2 and K3 wrappers: the padded SQ layout on
    one CUDA device."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    expect(fn, "codes", codes, (torch.uint8,), (None, None, None), dev)
    nlist, lmax, _ = codes.shape
    for name, t in (("rn", rn), ("rs", rs)):
        expect(fn, name, t, (torch.float32,), (nlist, lmax), dev)
    expect(fn, "counts", counts, (torch.int32,), (nlist,), dev)
    if mask is not None:
        expect(fn, "mask", mask, (torch.int8, torch.uint8, torch.bool),
               (nlist, lmax), dev)
    if metric not in METRICS:
        raise ValueError(f"{fn}: unsupported metric {metric}")
    if codec not in CODEC_ID:
        raise ValueError(f"{fn}: unsupported codec {codec}")


def check_digits(fn, digits, scalars, n, w, codec, dev):
    """(n, 2, digit_width) int8 digits, 4-byte aligned, and (n, 4) fp32
    scalars, 16-byte aligned."""
    expect(fn, "digits", digits, (torch.int8,),
           (n, 2, digit_width(w, codec)), dev)
    expect(fn, "scalars", scalars, (torch.float32,), (n, 4), dev)
    if digits.data_ptr() % 4 or scalars.data_ptr() % 16:
        raise ValueError(f"{fn}: digits must be 4-byte and scalars 16-byte "
                         f"aligned")


def vec_ok(codes: torch.Tensor, codec: str) -> bool:
    """Whether the kernels may read rows in whole 16-byte-aligned units."""
    return (codes.shape[-1] % VEC_BYTES[codec] == 0
            and codes.data_ptr() % 16 == 0)


def ivf_sq_scan_reference(codes, rn, rs, counts, probe_ids, digits, scalars,
                          mask, metric, codec):
    """Plain torch version: gather the probed code blocks, exact float64
    digit dots (ops/sq_digits.py), the fp32 epilogue, the count and mask;
    chunked over queries so the unpacked block stays under 2^26 float64
    values."""
    nlist, lmax, w = codes.shape
    nq, nprobe = probe_ids.shape
    width = digits.shape[-1]
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=codes.device)
    lane = torch.arange(lmax, device=codes.device)
    qc = max(1, (1 << 26) // max(nprobe * lmax * width, 1))
    for q0 in range(0, nq, qc):
        pids = probe_ids[q0:q0 + qc].long()
        n = pids.shape[0]
        dots = digit_dots(codes[pids].reshape(n, nprobe * lmax, w),
                          digits[q0:q0 + qc], codec, KERNEL_SHIFT[codec])
        s = int8_scores(dots[:, 0], dots[:, 1],
                        scalars[q0:q0 + qc, None, :],
                        rs[pids].reshape(n, -1), rn[pids].reshape(n, -1),
                        metric)
        valid = lane < counts[pids][:, :, None]
        if mask is not None:
            valid = valid & (mask[pids] != 0)
        out[q0:q0 + qc] = torch.where(valid, s.reshape(n, nprobe, lmax),
                                      _NEG_INF)
    return out


def ivf_sq_scan(codes: torch.Tensor, rn: torch.Tensor, rs: torch.Tensor,
                counts: torch.Tensor, probe_ids: torch.Tensor,
                digits: torch.Tensor, scalars: torch.Tensor,
                mask: torch.Tensor | None, metric: str,
                codec: str) -> torch.Tensor:
    """Raw (nq, nprobe, lmax) float32 int8-digit scores of every slot of
    every probed list (see the module docstring).  ``digits`` / ``scalars``
    come from ``sq_digits.query_digits`` with the codec's KERNEL_SHIFT."""
    global LAUNCHES
    if all(t.device.type == "cpu"
           for t in (codes, rn, rs, counts, probe_ids, digits, scalars)):
        return ivf_sq_scan_reference(codes, rn, rs, counts, probe_ids,
                                     digits, scalars, mask, metric, codec)
    fn = "ivf_sq_scan"
    check_sq_lists(fn, codes, rn, rs, counts, mask, metric, codec)
    nlist, lmax, w = codes.shape
    dev = codes.device
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, nprobe = probe_ids.shape
    check_digits(fn, digits, scalars, nq, w, codec, dev)
    if nq * nprobe >= 2 ** 31:
        raise ValueError(f"{fn}: {nq} x {nprobe} pairs exceed the grid")
    from ..utils.kernels import load_library

    lib = load_library()
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32, device=dev)
    if nq * nprobe == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.dfx_ivf_sq_scan(
            codes.data_ptr(), rn.data_ptr(), rs.data_ptr(), counts.data_ptr(),
            probe_ids.data_ptr(), digits.data_ptr(), scalars.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            nq, nprobe, nlist, lmax, w, CODEC_ID[codec],
            int(metric == "L2"), int(vec_ok(codes, codec)), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_sq_scan: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return out


def exact_rows_scores(xs: torch.Tensor, xq: torch.Tensor,
                      metric: str) -> torch.Tensor:
    """fp32 scores of each query against its own decoded rows (qb, c, d):
    inner product as a full-fp32 batched product (the JAX package's
    ``Precision.HIGHEST`` einsum), L2 as −Σ(x − q)²."""
    if metric == "INNER_PRODUCT":
        with full_fp32():
            return torch.bmm(xs, xq[:, :, None])[:, :, 0]
    diff = xs - xq[:, None, :]
    return -(diff * diff).sum(-1)


def sq_exact_rerank(codes, lids, lane, pos, best, xq, vmin, scale, *,
                    codec: str, k: int, metric: str):
    """The epilogue of the int8 list scans (``duckdb_faiss_ext_tpu/ops/
    pallas_ivf.py::sq_exact_rerank``): decode the k_scan selected rows
    (``lids``, ``lane``) from the padded layout, score them in fp32, take
    the top k.  ``best`` is the int8-score ranking (-inf missing); returns
    (scores (nq, k) fp32-exact, positions (nq, k), -1 missing).  Query
    blocks keep the decoded (qb, k_scan, d) tile near 2^25 values."""
    nq, k_scan = lids.shape
    d = vmin.shape[0]
    s2 = torch.empty((nq, k_scan), dtype=torch.float32, device=xq.device)
    qb = max(1, (1 << 25) // max(k_scan * d, 1))
    for q0 in range(0, nq, qb):
        rows = codes[lids[q0:q0 + qb], lane[q0:q0 + qb]]     # (qb, ks, w)
        n = rows.shape[0]
        xs = sq_decode(rows.reshape(n * k_scan, -1), vmin, scale,
                       codec).reshape(n, k_scan, d)
        s2[q0:q0 + qb] = exact_rows_scores(xs, xq[q0:q0 + qb], metric)
    s2 = torch.where(torch.isneginf(best), _NEG_INF, s2)
    best, sel2 = exact_topk(s2, k)
    pos = pos.gather(1, sel2)
    return best, torch.where(torch.isneginf(best), -1, pos)


def ivf_sq_list_search_reference(codes, rn, rs, counts, row_pos, probe_ids,
                                 xq, mask, vmin, scale, *, k, k_scan, metric,
                                 codec):
    """Plain version of ``ivf_sq_list_search``: the raw int8 score block,
    top-k_scan over (probe slot, slot) with the lower flat index on ties,
    positions through ``row_pos``, ``sq_exact_rerank``."""
    nq, nprobe = probe_ids.shape
    lmax, w = codes.shape[1], codes.shape[2]
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    raw = ivf_sq_scan_reference(codes, rn, rs, counts, probe_ids, q.digits,
                                q.scalars, mask, metric, codec)
    return topk_rerank(codes, row_pos, probe_ids,
                       raw.reshape(nq, nprobe * lmax), xq, vmin, scale, k=k,
                       k_scan=k_scan, metric=metric, codec=codec)


def topk_rerank(codes, row_pos, probe_ids, raw, xq, vmin, scale, *, k,
                k_scan, metric, codec):
    """Top-k_scan of raw (nq, nprobe · lmax) int8 scores, resolved and
    reranked exactly (``sq_exact_rerank``)."""
    lmax = codes.shape[1]
    best, sel = exact_topk(raw, min(k_scan, raw.shape[1]))
    lane = sel % lmax
    lids = probe_ids.long().gather(1, sel // lmax)
    pos = row_pos[lids, lane]
    return sq_exact_rerank(codes, lids, lane, pos, best, xq, vmin, scale,
                           codec=codec, k=k, metric=metric)


def plan(nq, nprobe, nlist, lmax, w, d, k, k_scan, codec, n_sm, tma=True):
    """The fused search's launch shape (ops/list_topk.py::plan) with k2 =
    k_scan (at most nprobe · lmax), the query's digits in the partial
    block's shared memory, and a merge block of MERGE_WARPS warps holding
    the candidates' flat indices and the query, scale and vmin."""
    k2 = min(k_scan, nprobe * lmax)
    return lt.plan(nq=nq, nprobe=nprobe, nlist=nlist, lmax=lmax, row_bytes=w,
                   k=k, k2=k2, n_sm=n_sm, extra=2 * digit_width(w, codec),
                   tma=tma, merge_warps=MERGE_WARPS,
                   merge_extra=4 * k2 + 12 * d)


def walk(codes, rn, rs, counts, row_pos, probe_ids, xq, mask, vmin, scale, *,
         k, k_scan, metric, codec, n_sm):
    """Plain walk of the fused search on ``plan``'s shapes: the raw plain
    int8 scores, each (split, warp)'s best k_scan rows over the chunks the
    kernel hands it, their merge (ops/list_topk.py::walk_candidates), then
    the rescore and the resolve (``sq_exact_rerank``).  Returns (scores
    (nq, k), positions (nq, k), candidate scores, candidate flat indices
    (nq, k2), -1 missing)."""
    nlist, lmax, w = codes.shape
    nq, nprobe = probe_ids.shape
    p = plan(nq, nprobe, nlist, lmax, w, vmin.shape[0], k, k_scan, codec,
             n_sm)
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    raw = ivf_sq_scan_reference(codes, rn, rs, counts, probe_ids, q.digits,
                                q.scalars, mask, metric,
                                codec).reshape(nq, -1)
    cs, cf = lt.walk_candidates(raw, counts, probe_ids, p)
    f = cf.clamp(min=0)
    lane = f % lmax
    lids = probe_ids.long().gather(1, f // lmax)
    s, pos = sq_exact_rerank(codes, lids, lane, row_pos[lids, lane], cs, xq,
                             vmin, scale, codec=codec, k=k, metric=metric)
    s, pos = lt.pad_to(s, pos, k)
    return s, pos.to(torch.int32), cs, cf


def _check_search(codes, rn, rs, counts, row_pos, probe_ids, xq, mask, vmin,
                  scale, k, k_scan, metric, codec):
    """Raise unless the fused search takes these inputs."""
    fn = "ivf_sq_list_search"
    check_sq_lists(fn, codes, rn, rs, counts, mask, metric, codec)
    nlist, lmax, _ = codes.shape
    dev = codes.device
    expect(fn, "row_pos", row_pos, (torch.int32,), (nlist, lmax), dev)
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, nprobe = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, None), dev)
    d = xq.shape[1]
    for name, t in (("vmin", vmin), ("scale", scale)):
        expect(fn, name, t, (torch.float32,), (d,), dev)
    if nprobe < 1 or nprobe * lmax + 32 >= 2 ** 31:
        raise ValueError(f"{fn}: {nprobe} probes x {lmax} slots do not fit "
                         f"int32 flat indices")
    if k < 1 or not 1 <= min(k_scan, nprobe * lmax) <= MAX_K:
        raise ValueError(f"{fn}: k = {k}, k_scan = {k_scan} outside the "
                         f"fused search's [1, {MAX_K}]")


class TopKLaunch:
    """One fused ``ivf_sq_list_search`` call on the card, checked and
    planned: the query's digits, its outputs (``scores``, ``positions``),
    the merged int8 candidates (``candidates``: scores and flat indices,
    (nq, k2), -1 missing) and one workspace holding the splits' lists.
    ``run(stages)`` launches the named stages on the current stream (both
    by default)."""

    def __init__(self, codes, rn, rs, counts, row_pos, probe_ids, xq, mask,
                 vmin, scale, *, k, k_scan, metric, codec):
        _check_search(codes, rn, rs, counts, row_pos, probe_ids, xq, mask,
                      vmin, scale, k, k_scan, metric, codec)
        nlist, lmax, w = codes.shape
        nq, nprobe = probe_ids.shape
        d = xq.shape[1]
        dev = codes.device
        q = query_digits(xq, vmin, scale, metric, codec, w,
                         KERNEL_SHIFT[codec])
        check_digits("ivf_sq_list_search", q.digits, q.scalars, nq, w, codec,
                     dev)
        vec = vec_ok(codes, codec)
        self.plan = p = plan(nq, nprobe, nlist, lmax, w, d, k, k_scan, codec,
                             lt.sm_count(dev), lt.tma_ok(codes))
        self._ws = ws = lt.Workspace(p, dev, extra=1)
        self.scores, self.positions = ws.scores, ws.positions
        self.candidates = ws.lists[0]
        self._dev = dev
        self._args = (
            codes.data_ptr(), rn.data_ptr(), rs.data_ptr(), counts.data_ptr(),
            row_pos.data_ptr(), probe_ids.data_ptr(), q.digits.data_ptr(),
            q.scalars.data_ptr(), xq.data_ptr(), vmin.data_ptr(),
            scale.data_ptr(), mask.data_ptr() if mask is not None else None,
            ws.plan_ints, d, CODEC_ID[codec], int(metric == "L2"), int(vec),
            ws.part_s.data_ptr(), ws.part_p.data_ptr(),
            self.candidates[0].data_ptr(), self.candidates[1].data_ptr(),
            ws.scores.data_ptr(), ws.positions.data_ptr())
        # The tensors behind the pointers live as long as this launch.
        self._keep = (codes, rn, rs, counts, row_pos, probe_ids, q, xq, mask,
                      vmin, scale)

    def run(self, stages: int = lt.PARTIAL | lt.MERGE) -> None:
        from ..utils.kernels import load_library

        if self.plan["nq"] == 0:
            return
        with torch.cuda.device(self._dev):
            err = load_library().dfx_ivf_sq_topk(
                *self._args, stages,
                torch.cuda.current_stream(self._dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ivf_sq_list_search: CUDA launch failed "
                               f"with error {err}")


def ivf_sq_list_search_raw(codes, rn, rs, counts, row_pos, probe_ids, xq,
                           mask, vmin, scale, *, k, k_scan, metric, codec):
    """The search above the fused search's k_scan limit, and the design
    the fused search replaced: the raw launch's (nq, nprobe, lmax) int8
    score block, torch's top-k_scan, ``sq_exact_rerank``."""
    nq, nprobe = probe_ids.shape
    q = query_digits(xq, vmin, scale, metric, codec, codes.shape[2],
                     KERNEL_SHIFT[codec])
    raw = ivf_sq_scan(codes, rn, rs, counts, probe_ids, q.digits, q.scalars,
                      mask, metric, codec)
    return topk_rerank(codes, row_pos, probe_ids, raw.reshape(nq, -1), xq,
                       vmin, scale, k=k, k_scan=k_scan, metric=metric,
                       codec=codec)


def ivf_sq_list_search(codes, rn, rs, counts, row_pos, probe_ids, xq, mask,
                       vmin, scale, *, k, k_scan, metric, codec):
    """``pallas_ivf_sq_search``'s contract: (scores (nq, k) max-oriented
    fp32-exact, positions (nq, k) int32 original rows, -1 missing).  The
    k_scan best int8 scores (the lower flat index on ties) are rescored in
    fp32 and the best k kept (equal fp32 scores in int8 order).  On CUDA
    tensors the fused search when min(k_scan, nprobe · lmax) <= MAX_K, and
    above it ``ivf_sq_list_search_raw``; on CPU tensors
    ``ivf_sq_list_search_reference``."""
    global TOPK_LAUNCHES
    if all(t.device.type == "cpu" for t in (codes, rn, rs, counts, row_pos,
                                            probe_ids, xq)):
        return ivf_sq_list_search_reference(
            codes, rn, rs, counts, row_pos, probe_ids, xq, mask, vmin, scale,
            k=k, k_scan=k_scan, metric=metric, codec=codec)
    nq, nprobe = probe_ids.shape
    if min(k_scan, nprobe * codes.shape[1]) > MAX_K:
        return ivf_sq_list_search_raw(
            codes, rn, rs, counts, row_pos, probe_ids, xq, mask, vmin, scale,
            k=k, k_scan=k_scan, metric=metric, codec=codec)
    launch = TopKLaunch(codes, rn, rs, counts, row_pos, probe_ids, xq, mask,
                        vmin, scale, k=k, k_scan=k_scan, metric=metric,
                        codec=codec)
    if nq > 0:
        launch.run()
        TOPK_LAUNCHES += 1
    return launch.scores, launch.positions
