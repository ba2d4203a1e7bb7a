"""Fused L2 / inner-product distance + top-k: the hand-written CUDA kernel
``csrc/flat_topk.cu``, its wrapper, and its plain torch version.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_topk.py::
_topk_kernel`` (with the sort and slice of ``_pallas_topk`` and
``finalize_scores``).  The (nq, cap) score matrix never exists: each block
keeps a running top-k per query in shared memory.

What bounds it on the H100: at a small batch (b48 over 1M x 128 fp32)
reading the corpus, 512 MB at 3.35 TB/s; at b1024 fp32 FMA throughput.
This first version runs well above both floors; PERF.md records where
its time goes.
The design (details in the CUDA source): the corpus is split across enough
blocks to fill the card, each block writes its split's sorted top-k, and a
second launch merges the splits.  Blocks that share a split run side by
side so the corpus rows they both read come from L2.

``flat_topk`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; it takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils.config import next_pow2
from .flat_search import finalize_scores, search_scan

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

METRICS = ("INNER_PRODUCT", "L2")
MAX_K = 1024
_NT, _DK, _WARPS = 128, 32, 8            # tile shape of the CUDA source
_SMEM_PREFERRED = 113 * 1024             # two blocks fit in an SM
_MERGE_SMEM = 64 * 1024
_BLOCKS_PER_SM = 4


def _slots(k: int) -> int:
    """Per-query shared-memory slots: k sorted + at least max(k, 32)
    candidate slots, rounded to the bitonic sort's power of two."""
    return next_pow2(k + max(k, 32))


def _partial_smem(qt: int, slots: int) -> int:
    return 4 * (qt * _DK + _DK * (_NT + 1) + _NT) + 8 * qt * slots


def supports(metric: str, k: int, d: int) -> bool:
    """Whether the kernel takes this (metric, k, d)."""
    return metric in METRICS and 1 <= k <= MAX_K and d >= 1


def plan(nq: int, d: int, k: int, n_scan: int, n_sm: int) -> dict:
    """Launch shape: queries per warp (rq), corpus splits and the merge
    launch's warps per block."""
    slots = _slots(k)
    rq = 1
    for cand in (4, 2):
        qt = _WARPS * cand
        if qt <= next_pow2(max(nq, 1)) and \
                _partial_smem(qt, slots) <= _SMEM_PREFERRED:
            rq = cand
            break
    qtiles = -(-nq // (_WARPS * rq))
    tiles = max(1, -(-n_scan // _NT))
    splits = max(1, min(tiles, -(-_BLOCKS_PER_SM * n_sm // qtiles)))
    rows_per_split = -(-tiles // splits) * _NT
    splits = max(1, -(-n_scan // rows_per_split))
    return {"rq": rq, "splits": splits, "rows_per_split": rows_per_split,
            "slots": slots,
            "merge_warps": max(1, min(_WARPS, _MERGE_SMEM // (8 * slots)))}


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
    scores (IP: x·y; L2: -squared distance), sorted score descending then
    position ascending; missing slots are (-inf, -1)."""
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
    part_s = torch.empty((nq, p["splits"], k), dtype=torch.float32, device=dev)
    part_p = torch.empty((nq, p["splits"], k), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((nq, k), dtype=torch.int32, device=dev)
    vec4 = d % 4 == 0 and xb.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        err = lib.dfx_flat_topk(
            xb.data_ptr(), xq.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            nq, d, nvalid, k, int(metric == "L2"), p["rq"], int(vec4),
            p["splits"], p["rows_per_split"], p["slots"], p["merge_warps"],
            part_s.data_ptr(), part_p.data_ptr(), out_s.data_ptr(),
            out_p.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flat_topk: CUDA launch failed with error {err}")
    LAUNCHES += 1
    return out_s, out_p


def kernel_flat_search(xb_pad, nvalid, xq_pad, k, metric, mask=None):
    """``flat_topk`` under the ops.flat_search.flat_search contract
    (distances with FAISS sentinels, positions -1 when missing)."""
    scores, pos = flat_topk(xb_pad, nvalid, xq_pad, k, metric, mask)
    return finalize_scores(scores, pos, metric)
