"""Per-query IVF,Flat list scan (K6): the hand-written CUDA kernel
``csrc/ivf_list_scan.cu``, its wrapper, and its plain torch version.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
_scan_kernel`` (wrapper ``pallas_ivf_search``).  Lists are stored padded
as (nlist, lmax, d) fp32; for every (query, probed list) the kernel writes
the scores of all lmax slots, max-oriented (inner product ``x·q``, L2
``-Σ(x-q)²`` in difference form, as the TPU kernel computes it), with -inf
where the slot is at or beyond the list's count or its mask byte is 0.
Top-k and position resolve stay outside, in torch, as they stay outside
the ``pallas_call`` in the JAX package.

What bounds it on the H100: reading the probed list blocks (each block
reads count x d x 4 bytes of its list) and writing the (nq, nprobe, lmax)
score block.  The design (details in the CUDA source): one block per
(query, probed list) reads the list id from ``probe_ids`` on the device,
one warp per list row with 16-byte loads along d and a warp reduction;
rows at or beyond the count are never read.

``ivf_list_scan`` launches the kernel for CUDA tensors and raises on what
the kernel does not take; it takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from .flat_search import exact_topk

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

METRICS = ("INNER_PRODUCT", "L2")
_NEG_INF = float("-inf")


def expect(fn: str, what: str, t: torch.Tensor, dtypes, shape,
           dev: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` and
    of ``shape`` (None matches any extent) on ``dev``."""
    if t.device != dev:
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    if (t.dtype not in dtypes or t.dim() != len(shape)
            or any(s is not None and s != n for s, n in zip(shape, t.shape))
            or not t.is_contiguous()):
        raise ValueError(f"{fn}: {what} must be a contiguous {shape} "
                         f"{dtypes[0]} tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")


def check_lists(fn: str, lists, counts, mask, metric) -> None:
    """Checks shared by the K6 and K7 wrappers: the padded list layout on
    one CUDA device."""
    dev = lists.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    expect(fn, "lists", lists, (torch.float32,), (None, None, None), dev)
    nlist, lmax, _ = lists.shape
    expect(fn, "counts", counts, (torch.int32,), (nlist,), dev)
    if mask is not None:
        expect(fn, "mask", mask, (torch.int8, torch.uint8, torch.bool),
               (nlist, lmax), dev)
    if metric not in METRICS:
        raise ValueError(f"{fn}: unsupported metric {metric}")


def ivf_list_scan_reference(lists, counts, probe_ids, xq, mask, metric):
    """Plain torch version: gather the probed list blocks, score, mask;
    chunked over queries so the gathered block stays under 2^26 floats
    (b1024 x nprobe 64 x lmax 1024 x d 128 unchunked is 34 GB)."""
    nlist, lmax, d = lists.shape
    nq, nprobe = probe_ids.shape
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=lists.device)
    lane = torch.arange(lmax, device=lists.device)
    qc = max(1, (1 << 26) // max(nprobe * lmax * d, 1))
    for q0 in range(0, nq, qc):
        pids = probe_ids[q0:q0 + qc].long()
        block = lists[pids]                                 # (qc, np, L, d)
        q = xq[q0:q0 + qc][:, None, None, :]
        if metric == "INNER_PRODUCT":
            s = (block * q).sum(-1)
        else:
            diff = block - q
            s = -(diff * diff).sum(-1)
        valid = lane < counts[pids][:, :, None]
        if mask is not None:
            valid = valid & (mask[pids] != 0)
        out[q0:q0 + qc] = torch.where(valid, s, _NEG_INF)
    return out


def ivf_list_scan(lists: torch.Tensor, counts: torch.Tensor,
                  probe_ids: torch.Tensor, xq: torch.Tensor,
                  mask: torch.Tensor | None, metric: str) -> torch.Tensor:
    """Raw (nq, nprobe, lmax) float32 scores of every slot of every probed
    list (see the module docstring)."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (lists, counts, probe_ids, xq)):
        return ivf_list_scan_reference(lists, counts, probe_ids, xq, mask,
                                       metric)
    fn = "ivf_list_scan"
    check_lists(fn, lists, counts, mask, metric)
    nlist, lmax, d = lists.shape
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None),
           lists.device)
    nq, nprobe = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, d), lists.device)
    if nq * nprobe >= 2 ** 31:
        raise ValueError(f"{fn}: {nq} x {nprobe} pairs exceed the grid")
    from ..utils.kernels import load_library

    lib = load_library()
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=lists.device)
    if nq * nprobe == 0:
        return out
    vec4 = d % 4 == 0 and lists.data_ptr() % 16 == 0 \
        and xq.data_ptr() % 16 == 0
    with torch.cuda.device(lists.device):
        err = lib.dfx_ivf_list_scan(
            lists.data_ptr(), counts.data_ptr(), probe_ids.data_ptr(),
            xq.data_ptr(), mask.data_ptr() if mask is not None else None,
            nq, nprobe, nlist, lmax, d, int(metric == "L2"), int(vec4),
            out.data_ptr(),
            torch.cuda.current_stream(lists.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_list_scan: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return out


def ivf_list_search(lists, counts, row_pos, probe_ids, xq, mask, *, k,
                    metric):
    """``pallas_ivf_search``'s contract: (scores (nq, k) max-oriented with
    -inf missing, positions (nq, k) int32 original rows, -1 missing).  The
    raw scores come from ``ivf_list_scan``; top-k over (probe slot, lane)
    takes the lower flat index on ties, and positions resolve through
    ``row_pos``."""
    nq, nprobe = probe_ids.shape
    lmax = lists.shape[1]
    raw = ivf_list_scan(lists, counts, probe_ids, xq, mask, metric)
    best, sel = exact_topk(raw.reshape(nq, nprobe * lmax), k)
    lids = probe_ids.long().gather(1, sel // lmax)
    pos = row_pos[lids, sel % lmax]
    return best, torch.where(torch.isneginf(best), -1, pos)
