"""Per-query IVF,SQ8/SQ4/SQ6 int8 list scan (K2): the hand-written CUDA
kernel ``csrc/ivf_sq_scan.cu``, its wrapper, its plain torch version, and
the exact rerank every int8 list scan ends in.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
_sq_scan_kernel`` (wrapper ``pallas_ivf_sq_search``).  Codes are stored
padded as (nlist, lmax, w) uint8 packed rows, with the per-slot Σ(scale·c)²
(``rn``) and Σc (``rs``) beside them (models/ivf_layout.py).  For every
(query, probed list) the kernel writes the int8-digit scores of all lmax
slots (ops/sq_digits.py gives the formula), -inf at or beyond the list's
count and where the mask byte is 0.  Outside it, as outside the
``pallas_call`` in the JAX package: the top ``k_scan`` of the raw scores,
then ``sq_exact_rerank`` decodes the selected rows and scores them in
fp32, so the distances returned are exact.

What bounds it on the H100: the probed lists' code bytes (count x w per
pair) and the (nq, nprobe, lmax) score block.  The design (details in the
CUDA source): one block per (query, probed list), the query's digits in
shared memory, a warp per row unpacking 16-byte units in registers into
``__dp4a`` dots (csrc/sq_digits.cuh).

``ivf_sq_scan`` launches the kernel for CUDA tensors and raises on what the
kernel does not take; it takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils.config import full_fp32
from .flat_search import exact_topk
from .ivf_list_scan import expect
from .sq import sq_decode
from .sq_digits import (CODEC_ID, KERNEL_SHIFT, METRICS, digit_dots,
                        digit_width, int8_scores, query_digits)

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

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


def ivf_sq_list_search(codes, rn, rs, counts, row_pos, probe_ids, xq, mask,
                       vmin, scale, *, k, k_scan, metric, codec):
    """``pallas_ivf_sq_search``'s contract: (scores (nq, k) max-oriented
    fp32-exact, positions (nq, k) int32 original rows, -1 missing).  The
    raw scores come from ``ivf_sq_scan``; top-k_scan over (probe slot,
    lane) takes the lower flat index on ties; positions resolve through
    ``row_pos``; ``sq_exact_rerank`` keeps the best k."""
    nq, nprobe = probe_ids.shape
    lmax, w = codes.shape[1], codes.shape[2]
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    raw = ivf_sq_scan(codes, rn, rs, counts, probe_ids, q.digits, q.scalars,
                      mask, metric, codec)
    best, sel = exact_topk(raw.reshape(nq, nprobe * lmax),
                           min(k_scan, nprobe * lmax))
    lane = sel % lmax
    lids = probe_ids.long().gather(1, sel // lmax)
    pos = row_pos[lids, lane]
    return sq_exact_rerank(codes, lids, lane, pos, best, xq, vmin, scale,
                           codec=codec, k=k, metric=metric)
