"""Pipelined pair-tile IVF,SQ8/SQ4/SQ6 int8 scan (K9): the hand-written CUDA
kernel ``csrc/ivf_sq_pairs_mega.cu`` and its wrapper.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
_pairs_sq_mega_kernel`` (``pallas_ivf_sq_pairs_search(..., mega=True)``),
which the JAX package runs under ``config.pairs_impl = "mega"``.  It
computes K3's function (ops/ivf_sq_pairs.py) on K3's inputs
(``sq_pair_tile_inputs``), so its plain version is K3's,
``ivf_sq_pairs_scan_reference``, and its raw (t_max, 8, lmax) tiles are
bit-equal to K3's.  What differs is how the operands move: persistent
blocks fetch tiles from a device counter (which the wrapper allocates
zeroed) and walk them as one sequence of 256-row x 128-byte chunks through
a ring of shared-memory stages, each chunk with the digits of its
dimensions, the next chunks (the next tile's first one included) in flight
while one computes.  A producer warp fills the ring with TMA boxes of the
payload and of the digit rows, on mbarriers; widths TMA does not take, and
sq6, run the kernel's ``cp.async`` instance (K3's ring, persistent; sq8 /
sq4 rows there copy as 16-byte windows, the ring's general form).  The
dots are K3's int8 tensor-core MMAs (``csrc/sq_mma.cuh``).

The search around it is K3's (``ivf_sq_pairs_search(..., mega=True)``):
pair gather, top ``k_scan``, ``sq_exact_rerank``.

What bounds it on the H100: the list bytes of the tiles, each read once a
tile; with TMA no thread spends issue slots on the copies.

Host side: ``tensor_maps`` gives the TMA views of the payload and of the
digit rows (shape, row stride, box) and ``tma_ok`` says when the kernel
takes them; the stage plan is K3's ``stage_plan``.

``ivf_sq_pairs_mega_scan`` launches the kernel for CUDA tensors and raises
on what the kernel does not take (K3's checks); it takes the plain version
only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import spanned
from .ivf_list_scan import expect
from .ivf_pairs import QG
from .ivf_sq_pairs import (check_pair_layout, digit_vec_ok,
                           ivf_sq_pairs_scan_reference, stage_plan)
from .ivf_sq_scan import check_digits, check_sq_lists, vec_ok
from .sq_digits import CODEC_ID

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

#: (shared-memory stages, blocks, TMA) of the last launch
last_plan = (0, 0, False)

#: TMA boxes: 128 bytes wide; code boxes 64 rows, digit boxes 8 rows (a
#: tile's hi or lo digit rows)
BOX_COLS, BOX_ROWS, DIGIT_BOX_ROWS = 128, 64, QG


def tensor_maps(codes: torch.Tensor, digits_t: torch.Tensor):
    """K9's two TMA views, each (bytes a row, rows, row stride, box
    width, box height): the (nlist, lmax, w) payload as (nlist·lmax, w)
    bytes in boxes of 64 rows x 128 bytes, and the (t_max·8, 2, width)
    digit rows as t_max·8 rows of ``width`` bytes 2·width apart (the hi
    rows; the kernel reads the lo rows through the same view ``width``
    bytes on) in boxes of 8 rows x 128 bytes.  Bytes past a row's width
    and rows past the tensor arrive as zeros."""
    nlist, lmax, w = codes.shape
    width = digits_t.shape[-1]
    return ((w, nlist * lmax, w, BOX_COLS, BOX_ROWS),
            (width, digits_t.shape[0], 2 * width, BOX_COLS, DIGIT_BOX_ROWS))


def tma_ok(codes: torch.Tensor, digits_t: torch.Tensor, codec: str) -> bool:
    """Whether K9 copies through TMA: sq8 / sq4 (whose 128-byte chunks hold
    whole k-steps), code and digit rows a multiple of 16 bytes and 16-byte
    aligned (the tensor maps' strides and bases)."""
    return (codec in ("sq8", "sq4") and codes.shape[2] % 16 == 0
            and codes.data_ptr() % 16 == 0 and digit_vec_ok(digits_t))


@spanned("kernels.ivf_sq_pairs_mega")
def ivf_sq_pairs_mega_scan(codes: torch.Tensor, rn: torch.Tensor,
                           rs: torch.Tensor, counts: torch.Tensor,
                           digits_t: torch.Tensor, scalars_t: torch.Tensor,
                           meta: torch.Tensor, mask: torch.Tensor | None,
                           metric: str, codec: str) -> torch.Tensor:
    """Raw (t_max, QG, lmax) float32 tile scores, as
    ``ivf_sq_pairs.ivf_sq_pairs_scan``."""
    global LAUNCHES, last_plan
    if all(t.device.type == "cpu"
           for t in (codes, rn, rs, counts, digits_t, scalars_t, meta)):
        return ivf_sq_pairs_scan_reference(codes, rn, rs, counts, digits_t,
                                           scalars_t, meta, mask, metric,
                                           codec)
    fn = "ivf_sq_pairs_mega_scan"
    check_sq_lists(fn, codes, rn, rs, counts, mask, metric, codec)
    nlist, lmax, w = codes.shape
    dev = codes.device
    expect(fn, "scalars_t", scalars_t, (torch.float32,), (None, QG, 4), dev)
    t_max = scalars_t.shape[0]
    check_digits(fn, digits_t, scalars_t.reshape(-1, 4), t_max * QG, w,
                 codec, dev)
    expect(fn, "meta", meta, (torch.int32,), (1 + t_max,), dev)
    check_pair_layout(fn, codes, rn, rs, mask)
    tma = tma_ok(codes, digits_t, codec)
    vec = vec_ok(codes, codec) and (tma or codec == "sq6")
    plan = stage_plan(w, codec, persistent=True, tma=tma, vec=vec)
    from ..utils.kernels import load_library

    lib = load_library()
    out = torch.empty((t_max, QG, lmax), dtype=torch.float32, device=dev)
    if t_max == 0:
        return out
    shape = (ctypes.c_longlong * 10)(*sum(tensor_maps(codes, digits_t), ()))
    next_tile = torch.zeros(1, dtype=torch.int32, device=dev)
    launched = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        err = lib.dfx_ivf_sq_pairs_mega(
            codes.data_ptr(), rn.data_ptr(), rs.data_ptr(), counts.data_ptr(),
            digits_t.data_ptr(), scalars_t.data_ptr(), meta.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            t_max, nlist, lmax, w, CODEC_ID[codec], int(metric == "L2"),
            int(vec), int(digit_vec_ok(digits_t)), int(tma), shape,
            digits_t.shape[-1], plan.chunk, plan.stages, plan.smem,
            next_tile.data_ptr(), out.data_ptr(), launched,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
    LAUNCHES += 1
    last_plan = (launched[0], launched[1], tma)
    return out
