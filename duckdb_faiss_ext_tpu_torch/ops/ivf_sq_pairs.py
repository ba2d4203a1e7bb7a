"""Pair-tile IVF,SQ8/SQ4/SQ6 int8 scan (K3): the hand-written CUDA kernel
``csrc/ivf_sq_pairs.cu``, its wrapper, its plain torch version, and the
search around it.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
_pairs_sq_kernel`` (wrapper ``pallas_ivf_sq_pairs_search``, grid branch).
The (nq, nprobe) probe map is inverted into tiles of one list and ``QG`` =
8 queries with the Flat pair tiles' table (ops/ivf_pairs.py::
``pair_tiles``); the kernel scores each tile's 8 queries against its
list's code block in one pass, writing raw (t_max, 8, lmax) int8-digit
scores (ops/sq_digits.py) with -inf on empty query slots (their ``base``
is +inf for L2, -inf for inner product, as in the JAX package), at or
beyond the list's count and on masked rows.  Tiles at or beyond
``n_tiles`` (``meta[0]``, read on the device) are left unwritten.

Outside the kernel, as outside the ``pallas_call``: each pair's row is
gathered back through ``pair_slot``, the top ``k_scan`` per query are
selected, and ``ivf_sq_scan.sq_exact_rerank`` decodes and rescores them in
fp32.  The JAX package's ``build_sweep_tiles`` / ``sweep=True`` full-corpus
tiling has no caller on the serving path and is not ported.

What bounds it on the H100: the code bytes of each tile's list, read once
for 8 queries.  The design (details in the CUDA source and
``csrc/sq_mma.cuh``): one block per tile streams its list through a
``cp.async`` ring of 256-row chunks in shared memory, and the dots run on
the int8 tensor cores (``mma.sync m16n8k32``, the 16 digit rows as A), so
the integer work no longer sets the pace.  ``stage_plan`` is the host
side of that design: chunk geometry, ring depth and shared memory,
shared with K9 (ops/ivf_sq_pairs_mega.py).

``ivf_sq_pairs_scan`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it takes the plain version only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .flat_search import exact_topk
from .ivf_list_scan import expect
from .ivf_pairs import QG, pair_tiles
from .ivf_sq_scan import (check_digits, check_sq_lists, sq_exact_rerank,
                          vec_ok)
from .sq_digits import (CODEC_ID, KERNEL_SHIFT, Digits, digit_dots,
                        int8_scores, query_digits)

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

#: blocks an SM held at the last launch (the occupancy calculator's count)
last_blocks = 0

_NEG_INF = float("-inf")

#: list rows a chunk; code bytes a row per chunk (whole 32-dimension
#: k-steps and 16-byte pieces) and per k-step (csrc/sq_mma.cuh::Geo)
CHUNK_ROWS = 256
CHUNK_BYTES = {"sq8": 128, "sq4": 128, "sq6": 96}
STEP_BYTES = {"sq8": 32, "sq4": 16, "sq6": 24}
STEP_DIMS = 32
#: Hopper's shared memory: the most a block may opt into, an SM's, and
#: what the system keeps for each block
SMEM_BLOCK_MAX, SMEM_SM, SMEM_RESERVED = 232_448, 233_472, 1024
#: ring depths: the cp.async ring waits on at most 3 groups; the TMA ring's
#: mbarriers allow more
MAX_STAGES, MAX_STAGES_TMA = 4, 6
#: blocks an SM the kernels are built for (their launch bounds): K3 two,
#: the persistent K9 one
BLOCKS_K3, BLOCKS_K9 = 2, 1


class StagePlan(NamedTuple):
    """The shared-memory plan of the pair-tile kernels (K3, K9)."""
    chunk: int          # code bytes a row per chunk
    steps: int          # 32-dimension k-steps a whole chunk
    col_chunks: int     # chunks across a row
    stages: int
    smem: int           # bytes a block


def stage_plan(w: int, codec: str, *, persistent: bool, tma: bool = False,
               vec: bool = True) -> StagePlan:
    """The ring a block of K3 (``persistent=False``) or K9 keeps for rows
    of ``w`` code bytes: stages of one item each, 256 code rows of one
    chunk and the 16 digit rows over the chunk's dimensions, zero past the
    digit width.  Code rows take 128 bytes swizzled as TMA swizzles them
    (under ``tma``, or sq8 / sq4 rows in whole 16-byte units, ``vec``), else
    the chunk and a 16-byte window slack; digit rows take 128-dimension
    TMA boxes, or the chunk's dimensions plus 16 bytes, an odd number of
    16-byte units so ldmatrix's 8 rows meet 8 bank groups.  The most
    blocks an SM the launch bounds allow first (K3 two, K9 one), then the
    deepest ring.  The kernels refuse a ``smem`` below what they lay out
    (csrc/sq_mma.cuh::Ring, ivf_sq_pairs_mega.cu::smem_needed)."""
    chunk = CHUNK_BYTES[codec]
    steps = chunk // STEP_BYTES[codec]
    dims = steps * STEP_DIMS
    if tma:
        stage = CHUNK_ROWS * 128 + 2 * QG * dims
        depths, head, extra = MAX_STAGES_TMA, 1024, 32 + 16   # items, barriers
    else:
        row_pitch = 128 if vec and codec != "sq6" else chunk + 16
        stage = CHUNK_ROWS * row_pitch + 2 * QG * (dims + 16)
        depths, head, extra = MAX_STAGES, 64, 0
    cap = BLOCKS_K9 if persistent else BLOCKS_K3
    best, best_blocks = None, 0
    for stages in range(2, depths + 1):
        smem = head + stages * (stage + extra)
        if smem > SMEM_BLOCK_MAX:
            break
        blocks = min(SMEM_SM // (smem + SMEM_RESERVED), cap)
        if blocks >= best_blocks:
            best = StagePlan(chunk, steps, -(-w // chunk), stages, smem)
            best_blocks = blocks
    return best


def check_pair_layout(fn, codes, rn, rs, mask):
    """The pair-tile kernels' layout rules beside ``check_sq_lists``: rows
    are scored in pairs (float2 loads of ``rn`` / ``rs``, 2-byte loads of
    the mask)."""
    if (codes.shape[1] % 4 or codes.data_ptr() % 16 or rn.data_ptr() % 8
            or rs.data_ptr() % 8
            or (mask is not None and mask.data_ptr() % 4)):
        raise ValueError(f"{fn}: needs lmax a multiple of 4, 16-byte aligned "
                         f"codes, 8-byte aligned rn / rs and a 4-byte "
                         f"aligned mask")


def sq_pair_tile_inputs(probe_ids: torch.Tensor, q: Digits, nlist: int,
                        metric: str):
    """The kernel's inputs for a batch: (digits_t (t_max·QG, 2, width)
    int8, scalars_t (t_max, QG, 4) fp32 with the empty slots' base at
    +inf (L2) / -inf (IP), meta (1 + t_max,), pair_slot (nq, nprobe))
    over the ``ivf_pairs.pair_tiles`` table."""
    tile_q, meta, pair_slot = pair_tiles(probe_ids, nlist)
    safe_q = tile_q.clamp(min=0).long()
    digits_t = q.digits[safe_q].reshape(-1, 2, q.digits.shape[-1])
    scalars_t = q.scalars[safe_q]                            # (t, QG, 4)
    dead = float("inf") if metric == "L2" else _NEG_INF
    scalars_t[:, :, 2] = torch.where(tile_q < 0, dead, scalars_t[:, :, 2])
    return digits_t, scalars_t.contiguous(), meta, pair_slot


def ivf_sq_pairs_scan_reference(codes, rn, rs, counts, digits_t, scalars_t,
                                meta, mask, metric, codec):
    """Plain torch version: per chunk of tiles, the exact float64 digit
    dots of the tiles' 16 digit rows against their list blocks, the fp32
    epilogue, the count and mask.  Writes every tile; the kernel leaves
    those at or beyond ``meta[0]`` unwritten."""
    nlist, lmax, w = codes.shape
    t_max = scalars_t.shape[0]
    width = digits_t.shape[-1]
    out = torch.empty((t_max, QG, lmax), dtype=torch.float32,
                      device=codes.device)
    tile_list = meta[1:].long()
    lane = torch.arange(lmax, device=codes.device)
    tc = max(1, (1 << 26) // max(lmax * width, 1))
    for t0 in range(0, t_max, tc):
        lids = tile_list[t0:t0 + tc]
        n = lids.shape[0]
        dots = digit_dots(codes[lids],
                          digits_t[t0 * QG:(t0 + n) * QG].reshape(
                              n, 2 * QG, width),
                          codec, KERNEL_SHIFT[codec]).reshape(n, QG, 2, lmax)
        s = int8_scores(dots[:, :, 0], dots[:, :, 1],
                        scalars_t[t0:t0 + n, :, None, :],
                        rs[lids][:, None, :], rn[lids][:, None, :], metric)
        valid = lane < counts[lids][:, None]
        if mask is not None:
            valid = valid & (mask[lids] != 0)
        out[t0:t0 + n] = torch.where(valid[:, None, :], s, _NEG_INF)
    return out


def ivf_sq_pairs_scan(codes: torch.Tensor, rn: torch.Tensor,
                      rs: torch.Tensor, counts: torch.Tensor,
                      digits_t: torch.Tensor, scalars_t: torch.Tensor,
                      meta: torch.Tensor, mask: torch.Tensor | None,
                      metric: str, codec: str) -> torch.Tensor:
    """Raw (t_max, QG, lmax) float32 tile scores (see the module
    docstring); the inputs come from ``sq_pair_tile_inputs``."""
    global LAUNCHES, last_blocks
    if all(t.device.type == "cpu"
           for t in (codes, rn, rs, counts, digits_t, scalars_t, meta)):
        return ivf_sq_pairs_scan_reference(codes, rn, rs, counts, digits_t,
                                           scalars_t, meta, mask, metric,
                                           codec)
    fn = "ivf_sq_pairs_scan"
    check_sq_lists(fn, codes, rn, rs, counts, mask, metric, codec)
    nlist, lmax, w = codes.shape
    dev = codes.device
    expect(fn, "scalars_t", scalars_t, (torch.float32,), (None, QG, 4), dev)
    t_max = scalars_t.shape[0]
    check_digits(fn, digits_t, scalars_t.reshape(-1, 4), t_max * QG, w,
                 codec, dev)
    expect(fn, "meta", meta, (torch.int32,), (1 + t_max,), dev)
    check_pair_layout(fn, codes, rn, rs, mask)
    vec = vec_ok(codes, codec)
    plan = stage_plan(w, codec, persistent=False, vec=vec)
    from ..utils.kernels import load_library

    lib = load_library()
    out = torch.empty((t_max, QG, lmax), dtype=torch.float32, device=dev)
    if t_max == 0:
        return out
    width = digits_t.shape[-1]
    blocks = (ctypes.c_int * 1)()
    with torch.cuda.device(dev):
        err = lib.dfx_ivf_sq_pairs(
            codes.data_ptr(), rn.data_ptr(), rs.data_ptr(), counts.data_ptr(),
            digits_t.data_ptr(), scalars_t.data_ptr(), meta.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            t_max, nlist, lmax, w, CODEC_ID[codec], int(metric == "L2"),
            int(vec), int(digit_vec_ok(digits_t)), width, plan.chunk,
            plan.stages, plan.smem, out.data_ptr(), blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_sq_pairs_scan: CUDA launch failed with "
                           f"error {err}")
    LAUNCHES += 1
    last_blocks = blocks[0]
    return out


def digit_vec_ok(digits_t: torch.Tensor) -> bool:
    """Whether the kernels may copy digit rows in 16-byte pieces."""
    return digits_t.shape[-1] % 16 == 0 and digits_t.data_ptr() % 16 == 0


def ivf_sq_pairs_search(codes, rn, rs, counts, row_pos, probe_ids, xq, mask,
                        vmin, scale, *, k, k_scan, metric, codec,
                        mega=False):
    """``pallas_ivf_sq_pairs_search``'s contract: (scores (nq, k)
    max-oriented fp32-exact, positions (nq, k) int32 original rows, -1
    missing).  ``mega`` scans the tiles with K9 (ops/ivf_sq_pairs_mega.py)
    in place of K3."""
    nq, nprobe = probe_ids.shape
    nlist, lmax, w = codes.shape
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    digits_t, scalars_t, meta, pair_slot = sq_pair_tile_inputs(
        probe_ids, q, nlist, metric)
    if mega:
        from .ivf_sq_pairs_mega import ivf_sq_pairs_mega_scan as scan
    else:
        scan = ivf_sq_pairs_scan
    raw = scan(codes, rn, rs, counts, digits_t, scalars_t, meta, mask, metric,
               codec)
    pv = raw.reshape(-1, lmax)[pair_slot.reshape(-1).long()] \
        .reshape(nq, nprobe * lmax)
    best, sel = exact_topk(pv, min(k_scan, nprobe * lmax))
    lane = sel % lmax
    lids = probe_ids.long().gather(1, sel // lmax)
    pos = row_pos[lids, lane]
    return sq_exact_rerank(codes, lids, lane, pos, best, xq, vmin, scale,
                           codec=codec, k=k, metric=metric)
