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
zeroed) and walk them as one sequence of 256-row x 192-byte chunks through
a ring of shared-memory stages filled by asynchronous copies, the next
chunks (the next tile's first one included) in flight while one computes.

The search around it is K3's (``ivf_sq_pairs_search(..., mega=True)``):
pair gather, top ``k_scan``, ``sq_exact_rerank``.

What bounds it on the H100: K3's, the ``__dp4a`` rate and the digit
broadcasts feeding it, then the list bytes of the tiles.

``ivf_sq_pairs_mega_scan`` launches the kernel for CUDA tensors and raises
on what the kernel does not take (besides K3's checks: lmax a multiple of
4, 16-byte aligned codes, a 4-byte aligned mask, digits no wider than two
stages of shared memory hold); it takes the plain version only for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .ivf_list_scan import expect
from .ivf_pairs import QG
from .ivf_sq_pairs import ivf_sq_pairs_scan_reference
from .ivf_sq_scan import check_digits, check_sq_lists, vec_ok
from .sq_digits import CODEC_ID, digit_width

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

#: (shared-memory stages, blocks) of the last launch
last_plan = (0, 0)


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
    if lmax % 4 or codes.data_ptr() % 16 or (
            mask is not None and mask.data_ptr() % 4):
        raise ValueError(f"{fn}: needs lmax a multiple of 4, 16-byte aligned "
                         f"codes and a 4-byte aligned mask")
    from ..utils.kernels import load_library

    lib = load_library()
    out = torch.empty((t_max, QG, lmax), dtype=torch.float32, device=dev)
    if t_max == 0:
        return out
    words = digit_width(w, codec) // 4
    dvec = words % 4 == 0 and digits_t.data_ptr() % 16 == 0
    next_tile = torch.zeros(1, dtype=torch.int32, device=dev)
    plan = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        err = lib.dfx_ivf_sq_pairs_mega(
            codes.data_ptr(), rn.data_ptr(), rs.data_ptr(), counts.data_ptr(),
            digits_t.data_ptr(), scalars_t.data_ptr(), meta.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            t_max, nlist, lmax, w, CODEC_ID[codec], int(metric == "L2"),
            int(vec_ok(codes, codec)), int(dvec), next_tile.data_ptr(),
            out.data_ptr(), plan, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
    LAUNCHES += 1
    last_plan = (plan[0], plan[1])
    return out
