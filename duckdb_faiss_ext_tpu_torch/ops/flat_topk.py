"""Fused L2 / inner-product distance + top-k: the hand-written CUDA kernel
``csrc/flat_topk.cu``, its wrapper, and its plain torch version.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_topk.py::
_topk_kernel`` (with the sort and slice of ``_pallas_topk`` and
``finalize_scores``).  The (nq, cap) score matrix never exists: each block
keeps a running candidate list per query in shared memory.

What bounds it on the H100: at b1024 over 1M x 128 the operations, which
the kernel runs on the TF32 tensor cores (three products a term, 3xTF32);
at a small batch (b48 as 64 rows) reading the corpus, 512 MB at 3.35 TB/s.
The design (details in the CUDA source): the corpus is split across enough
blocks to fill the card, each block keeps the best k + m rows of its split
by their 3xTF32 scores, and a second launch merges the splits, rescores
the best k + m rows exactly in fp32 FMA and sorts them, so the result is
exact fp32 in both precision modes.  ``margin`` gives m; the merge counts
the queries whose (k + m)-th candidate lies within twice ``error_bound``
of the k-th exact score (``unproven``), a diagnostic.

``flat_topk`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; it takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils.config import next_pow2
from ..utils.kernels import DeviceCounter
from .flat_search import finalize_scores, search_scan

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

METRICS = ("INNER_PRODUCT", "L2")
MAX_K = 1024
_LD, _STAGES, _THREADS = 36, 3, 256     # shape of the CUDA source's ring
_QTILES = (64, 32, 16, 8)                # query tiles the kernel is built for
_SMEM_MAX = 227 * 1024
_WAVES = 1                               # blocks a split plan aims at, per SM
_MERGE_SMEM = 64 * 1024
_U = 2.0 ** -24

#: per device, the count of unproven queries, added to by every launch
#: until a caller zeroes it (``reset_unproven``)
_UNPROVEN = DeviceCounter()


def margin(k: int) -> int:
    """m: candidates kept beyond k per query and split (CUDA source note)."""
    return max(16, k // 8)


def error_bound(qn, bn_max, d: int, metric: str):
    """E of the CUDA source note: a bound on |3xTF32 score − fp32 FMA
    score| for a query of squared norm ``qn`` against rows of squared norm
    at most ``bn_max`` (the kernel's ``error_bound``)."""
    eps = (3.01 * 4 + 3 * -(-d // 8)) * 4 * _U + d * _U
    s = (qn * bn_max) ** 0.5 * 1.001
    if metric == "L2":
        return 2 * s * eps + (2 * d + 4) * _U * (qn + bn_max) + 8 * _U * s
    return s * eps


def _slots(k2: int) -> int:
    """Per-query shared-memory slots of the partial launch: k2 sorted + at
    least 64 candidates, a power of two."""
    return next_pow2(k2 + 64)


def _tile_rows(qt: int) -> int:
    """Corpus rows a tile of the partial launch."""
    return 256 if qt >= 32 else 128


def _partial_smem(qt: int, slots: int) -> int:
    nt = _tile_rows(qt)
    return (4 * _STAGES * (nt + qt) * _LD + 4 * _THREADS + nt + 16 * qt
            + 8 * qt * slots)


def supports(metric: str, k: int, d: int) -> bool:
    """Whether the kernel takes this (metric, k, d)."""
    return metric in METRICS and 1 <= k <= MAX_K and d >= 1


def plan(nq: int, d: int, k: int, n_scan: int, n_sm: int) -> dict:
    """Launch shape: candidates a query (k2 = k + m), the query tile (qt),
    corpus splits, and the merge launch's slots and warps per block."""
    k2 = k + margin(k)
    slots = _slots(k2)
    qt = next(q for q in _QTILES
              if _partial_smem(q, slots) <= _SMEM_MAX
              and (q <= next_pow2(max(nq, 1)) or q == _QTILES[-1]))
    nt = _tile_rows(qt)
    qtiles = -(-nq // qt)
    tiles = max(1, -(-n_scan // nt))
    splits = max(1, min(tiles, _WAVES * n_sm // qtiles))
    rows_per_split = -(-tiles // splits) * nt
    splits = max(1, -(-n_scan // rows_per_split))
    merge_slots = next_pow2(k2 + max(k2, 32))
    return {"k2": k2, "qt": qt, "splits": splits,
            "rows_per_split": rows_per_split, "slots": slots,
            "merge_slots": merge_slots,
            "merge_warps": max(1, min(8, _MERGE_SMEM // (8 * merge_slots)))}


def unproven(dev) -> int:
    """Queries counted unproven on ``dev`` since the last reset (reads the
    card: a synchronisation)."""
    return _UNPROVEN.read(dev)


def reset_unproven(dev) -> None:
    _UNPROVEN.reset(dev)


def flat_topk_reference(xb, nvalid, xq, k, metric, mask=None):
    """Plain torch version: chunked fp32 scores + ``torch.topk`` over keys
    ordered (score desc, position asc).  Same contract as ``flat_topk``."""
    return search_scan(xb, nvalid, xq, k, metric, mask=mask)


def _check(xb, nvalid, xq, k, metric, mask):
    if xb.device.type != "cuda" or xq.device != xb.device:
        raise ValueError("flat_topk: xb and xq must be on the same CUDA device")
    for name, t in (("xb", xb), ("xq", xq)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"flat_topk: {name} must be a contiguous 2-D "
                             f"float32 tensor, got {t.dtype} {tuple(t.shape)}")
    cap, d = xb.shape
    if xq.shape[0] < 1:
        raise ValueError("flat_topk: needs at least one query")
    if xq.shape[1] != d:
        raise ValueError(f"flat_topk: xq has {xq.shape[1]} dims, xb {d}")
    if cap >= 2 ** 31:
        raise ValueError(f"flat_topk: {cap} rows exceed int32 positions")
    if not 0 <= nvalid <= cap:
        raise ValueError(f"flat_topk: nvalid {nvalid} outside [0, {cap}]")
    if not supports(metric, k, d):
        raise ValueError(f"flat_topk: unsupported metric={metric} k={k} d={d}")
    if mask is not None and (
            mask.device != xb.device or mask.dim() != 1
            or mask.dtype not in (torch.bool, torch.int8, torch.uint8)
            or mask.shape[0] < nvalid or not mask.is_contiguous()):
        raise ValueError("flat_topk: mask must be a contiguous 1-byte (cap,) "
                         "tensor on the corpus device")


def flat_topk(xb: torch.Tensor, nvalid: int, xq: torch.Tensor, k: int,
              metric: str, mask: torch.Tensor | None = None):
    """Top-k of every query over rows [0, nvalid) of ``xb`` (and, with a
    mask, rows whose mask byte is non-zero).

    Returns (scores (nq, k) float32, positions (nq, k) int32): max-oriented
    fp32 scores (IP: x·y; L2: -squared distance), sorted score descending
    then position ascending; missing slots are (-inf, -1)."""
    global LAUNCHES
    nvalid = int(nvalid)
    if xb.device.type == "cpu" and xq.device.type == "cpu":
        return flat_topk_reference(xb, nvalid, xq, k, metric, mask)
    _check(xb, nvalid, xq, k, metric, mask)
    from ..utils.kernels import load_library

    lib = load_library()
    nq, d = xq.shape
    dev = xb.device
    p = plan(nq, d, k, nvalid,
             torch.cuda.get_device_properties(dev).multi_processor_count)
    k2 = p["k2"]
    part_s = torch.empty((nq, p["splits"], k2), dtype=torch.float32,
                         device=dev)
    part_p = torch.empty((nq, p["splits"], k2), dtype=torch.int32,
                         device=dev)
    bn_max = torch.zeros(1, dtype=torch.float32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((nq, k), dtype=torch.int32, device=dev)
    count = _UNPROVEN.tensor(dev)
    vec4 = (d % 4 == 0 and xb.data_ptr() % 16 == 0
            and xq.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = lib.dfx_flat_topk(
            xb.data_ptr(), xq.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            nq, d, nvalid, k, k2, int(metric == "L2"), p["qt"], int(vec4),
            p["splits"], p["rows_per_split"], p["slots"], p["merge_slots"],
            p["merge_warps"], part_s.data_ptr(), part_p.data_ptr(),
            bn_max.data_ptr(), out_s.data_ptr(), out_p.data_ptr(),
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flat_topk: CUDA launch failed with error {err}")
    LAUNCHES += 1
    return out_s, out_p


def kernel_flat_search(xb_pad, nvalid, xq_pad, k, metric, mask=None):
    """``flat_topk`` under the ops.flat_search.flat_search contract
    (distances with FAISS sentinels, positions -1 when missing)."""
    scores, pos = flat_topk(xb_pad, nvalid, xq_pad, k, metric, mask)
    return finalize_scores(scores, pos, metric)
