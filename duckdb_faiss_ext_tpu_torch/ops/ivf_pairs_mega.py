"""Pipelined pair-tile IVF,Flat search (K10): the hand-written CUDA kernels
``csrc/ivf_pairs_mega.cu`` and their wrappers.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
_pairs_flat_mega_kernel`` (``pallas_ivf_pairs_search(..., mega=True)``,
its epilogue included), which the JAX package runs under
``config.pairs_impl = "mega"``.  It computes K7's function on K7's inputs,
so its plain versions are K7's (ops/ivf_pairs.py):

* the fused search, ``ivf_pairs_search(..., mega=True)``: K7's items and
  3xTF32 core (``csrc/pairs_tf32.cuh``), candidates and results bit-equal
  to K7's; what differs is how the chunks move: persistent blocks (two an
  SM where the ring leaves room) take items from a device counter (in
  the item tables' head, zeroed by the wrapper and again by the launch's
  last block), and a producer warp fills a ring of stages, the rows as
  TMA boxes of 32 rows x 32 dims (``ops/ivf_pairs.py::tma_ok``: d a
  multiple of 4, lists and queries 16-byte aligned; the tensor map is
  encoded at each launch) and the queries with cp.async, on mbarriers,
  while 8 consumer warps compute; other widths run the kernel's cp.async
  instance.  ``last_plan`` holds the stages, the partial's blocks and
  whether TMA copied the rows;
* the raw launch ``ivf_pairs_mega_scan`` (the first pipelined design):
  K7's raw tiles, bit-equal, through persistent blocks and a cp.async
  ring of 256-row x 32-dim chunks, summing each row's dimensions in K7's
  order; the search takes it above the fused search's k_scan limit.  The
  JAX package fell back to its grid kernel when two fp32 list blocks
  overflowed its VMEM; the chunks here always fit, so there is no
  fallback.

What bounds it on the H100: K7's, the distinct probed rows read once.

``ivf_pairs_mega_scan`` launches the raw kernel for CUDA tensors and
raises on what the kernel does not take (besides K7's checks: lmax a
multiple of 4 and a 4-byte aligned mask); it takes the plain version only
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import spanned
from .ivf_pairs import QG, check_pairs, ivf_pairs_scan_reference

#: launches of the raw CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0
#: fused searches launched on the card through K10 since import (or since
#: a caller reset it): one for each run of both launches
TOPK_LAUNCHES = 0

#: (shared-memory stages, blocks, TMA) of the last launch
last_plan = (0, 0, False)


@spanned("kernels.ivf_pairs_mega")
def ivf_pairs_mega_scan(lists: torch.Tensor, counts: torch.Tensor,
                        xq_t: torch.Tensor, qs_t: torch.Tensor,
                        meta: torch.Tensor, mask: torch.Tensor | None,
                        metric: str) -> torch.Tensor:
    """Raw (t_max, QG, lmax) float32 tile scores, as
    ``ivf_pairs.ivf_pairs_scan``."""
    global LAUNCHES, last_plan
    if all(t.device.type == "cpu" for t in (lists, counts, xq_t, qs_t, meta)):
        return ivf_pairs_scan_reference(lists, counts, xq_t, qs_t, meta, mask,
                                        metric)
    fn = "ivf_pairs_mega_scan"
    check_pairs(fn, lists, counts, xq_t, qs_t, meta, mask, metric)
    nlist, lmax, d = lists.shape
    if lmax % 4 or (mask is not None and mask.data_ptr() % 4):
        raise ValueError(f"{fn}: needs lmax a multiple of 4 and a 4-byte "
                         f"aligned mask")
    from ..utils.kernels import load_library

    lib = load_library()
    t_max = xq_t.shape[0]
    out = torch.empty((t_max, QG, lmax), dtype=torch.float32,
                      device=lists.device)
    if t_max == 0:
        return out
    vec4 = (d % 4 == 0 and lists.data_ptr() % 16 == 0
            and xq_t.data_ptr() % 16 == 0)
    next_tile = torch.zeros(1, dtype=torch.int32, device=lists.device)
    plan = (ctypes.c_int * 2)()
    with torch.cuda.device(lists.device):
        err = lib.dfx_ivf_pairs_mega(
            lists.data_ptr(), counts.data_ptr(), xq_t.data_ptr(),
            qs_t.data_ptr(), meta.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            t_max, nlist, lmax, d, int(metric == "L2"), int(vec4),
            next_tile.data_ptr(), out.data_ptr(), plan,
            torch.cuda.current_stream(lists.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
    LAUNCHES += 1
    last_plan = (plan[0], plan[1], False)
    return out
