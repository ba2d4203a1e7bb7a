"""IVF-PQ / IVF-RQ list scan (K8): the hand-written CUDA kernel
``csrc/ivf_pq_scan.cu``, its wrapper, and its plain torch version.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
_gather_kernel`` (wrapper ``pallas_gather_lists``, caller
``pallas_ivf_pq_search``).  The TPU kernel only copied the probed
(lmax, m) code blocks into a compact (nq, nprobe, lmax, m) buffer; XLA then
decoded that buffer to fp32 rows in query chunks and scored them.  On the
card such a gather would copy what one indexing call copies, and leave the
code buffer (1.6 GB at b1024 x nprobe 64 x lmax 1536 x 16 B) and a decoded
tile 4·d/m times larger in device memory.  So K8 takes the gather and the
decode-and-score in one pass, with K6's contract (ops/ivf_list_scan.py):
for every (query, probed list) it writes the raw scores of all lmax slots,
max-oriented, each row decoded as x = dec(code) + centroid[list] (by
residual, faiss IndexIVFPQ), with

* PQ: dec_j = cb[j // dsub][code[j // dsub]][j % dsub];
* RQ: dec_j = Σ_s cb[s][code_s][j], summed in stage order;
* inner product x·q, L2 −Σ(x − q)² in difference form;
* -inf at slots at or past the list's count, or whose mask byte is 0.

Top-k, the position resolve and the spill merge stay outside, in torch.

What bounds it on the H100: writing the (nq, nprobe, lmax) fp32 score
block (403 MB at b1024, nprobe 64, lmax 1536: 0.12 ms at 3.35 TB/s); the
codes it reads are lmax·m bytes a pair, and the FLOPs 2·d a probed row.
The design (details in the CUDA source): one block per (query, probed list)
reads the list id on the device, stages the query and the list's centroid
in shared memory, and one warp scores one row at a time with its lanes
along d, the row's m code bytes read once into shared memory, the codebook
entries through L2, and a warp reduction.  Rows at or beyond the count are
never read.

``ivf_pq_scan`` launches the kernel for CUDA tensors and raises on what the
kernel does not take; it takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from .flat_search import exact_topk
from .ivf_list_scan import METRICS, expect
from .pq import codec_decode

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

CODECS = ("pq", "rq")
_NEG_INF = float("-inf")


def gather_lists(lists: torch.Tensor, probe_ids: torch.Tensor):
    """The probed list blocks, (nlist, lmax, w) → (nq, nprobe, lmax, w): the
    plain counterpart of the TPU kernel's own function
    (``pallas_gather_lists``)."""
    return lists[probe_ids.long()]


def ivf_pq_scan_reference(lists, counts, probe_ids, xq, centroids, codebooks,
                          mask, metric, codec):
    """Plain torch version: gather the probed code blocks, decode residual +
    probed centroid, score, mask; chunked over queries so the decoded tile
    stays under 2^26 floats."""
    nlist, lmax, m = lists.shape
    nq, nprobe = probe_ids.shape
    d = xq.shape[1]
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=lists.device)
    lane = torch.arange(lmax, device=lists.device)
    qc = max(1, (1 << 26) // max(nprobe * lmax * d, 1))
    for q0 in range(0, nq, qc):
        pids = probe_ids[q0:q0 + qc].long()
        codes = gather_lists(lists, pids)                 # (qc, np, L, m)
        n = pids.shape[0]
        x = (codec_decode(codes.reshape(-1, m), codebooks, codec)
             .reshape(n, nprobe, lmax, d) + centroids[pids][:, :, None, :])
        q = xq[q0:q0 + qc][:, None, None, :]
        if metric == "INNER_PRODUCT":
            s = (x * q).sum(-1)
        else:
            diff = x - q
            s = -(diff * diff).sum(-1)
        valid = lane < counts[pids][:, :, None]
        if mask is not None:
            valid = valid & (mask[pids] != 0)
        out[q0:q0 + qc] = torch.where(valid, s, _NEG_INF)
    return out


def _check(lists, counts, probe_ids, xq, centroids, codebooks, mask, metric,
           codec):
    """Raise unless the kernel takes these inputs."""
    fn = "ivf_pq_scan"
    dev = lists.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    expect(fn, "lists", lists, (torch.uint8,), (None, None, None), dev)
    nlist, lmax, m = lists.shape
    expect(fn, "counts", counts, (torch.int32,), (nlist,), dev)
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, _ = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, None), dev)
    d = xq.shape[1]
    expect(fn, "centroids", centroids, (torch.float32,), (nlist, d), dev)
    if codec not in CODECS:
        raise ValueError(f"{fn}: unsupported codec {codec}")
    width = None if codec == "pq" else d
    expect(fn, "codebooks", codebooks, (torch.float32,), (m, None, width),
           dev)
    ksub, dsub = codebooks.shape[1], codebooks.shape[2]
    if codec == "pq" and m * dsub != d:
        raise ValueError(f"{fn}: {m} subquantizers of {dsub} dims do not "
                         f"make d = {d}")
    if ksub < 1 or ksub > 256 or ksub & (ksub - 1):
        raise ValueError(f"{fn}: ksub {ksub} is not a power of two <= 256")
    if mask is not None:
        expect(fn, "mask", mask, (torch.int8, torch.uint8, torch.bool),
               (nlist, lmax), dev)
    if metric not in METRICS:
        raise ValueError(f"{fn}: unsupported metric {metric}")
    if nq * probe_ids.shape[1] >= 2 ** 31:
        raise ValueError(f"{fn}: {nq} x {probe_ids.shape[1]} pairs exceed "
                         f"the grid")


def ivf_pq_scan(lists: torch.Tensor, counts: torch.Tensor,
                probe_ids: torch.Tensor, xq: torch.Tensor,
                centroids: torch.Tensor, codebooks: torch.Tensor,
                mask: torch.Tensor | None, metric: str,
                codec: str) -> torch.Tensor:
    """Raw (nq, nprobe, lmax) float32 scores of every slot of every probed
    list (see the module docstring)."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (lists, counts, probe_ids, xq,
                                            centroids, codebooks)):
        return ivf_pq_scan_reference(lists, counts, probe_ids, xq, centroids,
                                     codebooks, mask, metric, codec)
    _check(lists, counts, probe_ids, xq, centroids, codebooks, mask, metric,
           codec)
    from ..utils.kernels import load_library

    lib = load_library()
    nlist, lmax, m = lists.shape
    nq, nprobe = probe_ids.shape
    d = xq.shape[1]
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=lists.device)
    if nq * nprobe == 0:
        return out
    with torch.cuda.device(lists.device):
        err = lib.dfx_ivf_pq_scan(
            lists.data_ptr(), counts.data_ptr(), probe_ids.data_ptr(),
            xq.data_ptr(), centroids.data_ptr(), codebooks.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            nq, nprobe, nlist, lmax, m, d, codebooks.shape[1],
            codebooks.shape[2], int(codec == "rq"), int(metric == "L2"),
            out.data_ptr(),
            torch.cuda.current_stream(lists.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_pq_scan: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return out


def ivf_pq_list_search(lists, counts, row_pos, codebooks, centroids,
                       probe_ids, xq, mask, *, k, metric, codec):
    """``pallas_ivf_pq_search``'s contract: (scores (nq, k) max-oriented
    with -inf missing, positions (nq, k) int32 storage rows, -1 missing).
    The raw scores come from ``ivf_pq_scan``; top-k over (probe slot, lane)
    takes the lower flat index on ties, and positions resolve through
    ``row_pos``."""
    nq, nprobe = probe_ids.shape
    lmax = lists.shape[1]
    raw = ivf_pq_scan(lists, counts, probe_ids, xq, centroids, codebooks,
                      mask, metric, codec)
    best, sel = exact_topk(raw.reshape(nq, nprobe * lmax), k)
    lids = probe_ids.long().gather(1, sel // lmax)
    pos = row_pos[lids, sel % lmax]
    return best, torch.where(torch.isneginf(best), -1, pos)
