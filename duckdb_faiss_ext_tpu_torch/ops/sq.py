"""Scalar-quantizer codecs SQ8, SQ4 and SQ6, in plain torch and numpy.

The counterpart of ``duckdb_faiss_ext_tpu/ops/sq.py`` for the quantized
codecs (faiss::ScalarQuantizer QT_8bit / QT_4bit / QT_6bit with the
RS_minmax range, as the ``SQ8`` / ``SQ4`` / ``SQ6`` factory strings build
it): per-dimension [vmin, vmin + levels·scale] ranges trained by min / max,
codes ``round((x − vmin) / scale)`` clipped to [0, levels].

Packing (host numpy at ingest, as in the JAX package):

* SQ4: two 4-bit codes a byte, low nibble first → (n, ceil(d/2));
* SQ6: four 6-bit codes per 3 bytes, big-endian bit order →
  (n, 3·ceil(d/4)).

``sq_quantize`` divides by ``scale`` and rounds half to even
(``torch.round``), as ``jnp.round`` does, so the codes are byte-equal to
the JAX package's from the same rows and ranges.

The float codecs ``fp16`` / ``bf16`` (``SQfp16`` / ``SQbf16``) need no
training: a row is stored as its half-width floats, rounded to nearest
even by ``torch``'s casts as numpy's and ml_dtypes' casts round them, and
kept as their little-endian bytes, (n, 2·d) uint8 — the checkpoint's form
(``float_encode`` / ``sq_decode``), byte-equal to the JAX package's.

The int8 scans score a query against codes with two int8 digits of the
query (``sq_query_digits``) and exact integer dots; ``SQ_INT8_SHIFT``
recentres the codes into int8 range.

``sq_search`` and ``sq_int8_search`` are the standalone SQ index's scans
(``duckdb_faiss_ext_tpu/ops/sq.py``, XLA with no Pallas kernel there, plain
torch here): a chunked decode + distance + running top-k, and the int8
digit-dot scan with its exact fp32 rerank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .distance import pairwise_tile
from .flat_search import SIMILARITY_METRICS, exact_topk, search_scan

#: quantization levels per codec (code range [0, levels])
SQ_LEVELS = {"sq8": 255, "sq4": 15, "sq6": 63}

#: training-free float codecs, stored as the bytes of half-width rows
FLOAT_CODECS = ("fp16", "bf16")

_NEG_INF = float("-inf")


def float_codec_dtype(codec: str) -> torch.dtype:
    """torch dtype of a float codec ('fp16' | 'bf16')."""
    return torch.bfloat16 if codec == "bf16" else torch.float16


def sq_ranges(vmin, scale, d: int, device):
    """Trained (vmin, scale) host arrays as (d,) fp32 tensors on ``device``;
    zeros when untrained (the float codecs, which do not read them)."""
    if vmin is None:
        z = torch.zeros(d, dtype=torch.float32, device=device)
        return z, z
    return (torch.from_numpy(vmin).to(device),
            torch.from_numpy(scale).to(device))


def float_encode(x: torch.Tensor, codec: str) -> torch.Tensor:
    """(n, d) fp32 → (n, 2·d) uint8: the rows cast to the codec's dtype
    (round to nearest even), as little-endian bytes."""
    return x.to(torch.float32).to(float_codec_dtype(codec)).contiguous() \
        .view(torch.uint8)

#: code shift per codec: c' = c − shift keeps codes in int8 range
SQ_INT8_SHIFT = {"sq8": 128, "sq4": 8, "sq6": 32}


def sq_train(x: torch.Tensor, levels: int):
    """Per-dimension (vmin (d,), scale (d,)) fp32 from training rows."""
    x = x.to(torch.float32)
    vmin = x.amin(0)
    vmax = x.amax(0)
    scale = (vmax - vmin).clamp(min=1e-20) / float(levels)
    return vmin, scale


def sq_quantize(x: torch.Tensor, vmin: torch.Tensor, scale: torch.Tensor,
                levels: int = 255) -> torch.Tensor:
    """(n, d) fp32 → (n, d) uint8 codes, unpacked."""
    q = torch.round((x.to(torch.float32) - vmin[None, :]) / scale[None, :])
    return q.clamp(0, levels).to(torch.uint8)


def sq_code_width(d: int, codec: str) -> int:
    """Packed bytes per row for a codec."""
    if codec == "sq4":
        return (d + 1) // 2
    if codec == "sq6":
        return 3 * ((d + 3) // 4)
    if codec in FLOAT_CODECS:
        return 2 * d
    return d


def sq_row_codes(w: int, codec: str) -> int:
    """Codes a packed row of w bytes holds (d rounded up to the packing)."""
    if codec == "sq4":
        return 2 * w
    if codec == "sq6":
        return 4 * (w // 3)
    return w


# --- bit packing (host, ingest path) --------------------------------------

def sq4_pack(q: np.ndarray) -> np.ndarray:
    """(n, d) codes 0..15 → (n, ceil(d/2)) packed bytes, low nibble first."""
    q = np.asarray(q, np.uint8)
    n, d = q.shape
    if d % 2:
        q = np.concatenate([q, np.zeros((n, 1), np.uint8)], axis=1)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)


def sq6_pack(q: np.ndarray) -> np.ndarray:
    """(n, d) codes 0..63 → (n, 3·ceil(d/4)) packed bytes."""
    q = np.asarray(q, np.uint16)
    n, d = q.shape
    pad = (-d) % 4
    if pad:
        q = np.concatenate([q, np.zeros((n, pad), np.uint16)], axis=1)
    g = q.reshape(n, -1, 4)
    b0 = (g[..., 0] << 2) | (g[..., 1] >> 4)
    b1 = ((g[..., 1] & 15) << 4) | (g[..., 2] >> 2)
    b2 = ((g[..., 2] & 3) << 6) | g[..., 3]
    return np.stack([b0, b1, b2], axis=-1).reshape(n, -1).astype(np.uint8)


def sq_pack(q: np.ndarray, codec: str) -> np.ndarray:
    """(n, d) unpacked codes → packed rows of the codec."""
    if codec == "sq4":
        return sq4_pack(q)
    if codec == "sq6":
        return sq6_pack(q)
    return np.asarray(q, np.uint8)


def sq4_unpack_host(packed: np.ndarray, d: int) -> np.ndarray:
    """Inverse of sq4_pack: (n, ceil(d/2)) bytes → (n, d) codes 0..15."""
    lo = packed & np.uint8(15)
    hi = packed >> 4
    return np.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)[:, :d]


def sq6_unpack_host(packed: np.ndarray, d: int) -> np.ndarray:
    """Inverse of sq6_pack: (n, 3·ceil(d/4)) bytes → (n, d) codes 0..63."""
    n = packed.shape[0]
    g = packed.reshape(n, -1, 3)
    b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
    c0 = b0 >> 2
    c1 = ((b0 & 3) << 4) | (b1 >> 4)
    c2 = ((b1 & 15) << 2) | (b2 >> 6)
    c3 = b2 & 63
    return np.stack([c0, c1, c2, c3], axis=-1).reshape(n, -1)[:, :d]


def sq_pack_t(q: torch.Tensor, codec: str) -> torch.Tensor:
    """``sq_pack`` on the codes' device (device-resident ingest): (n, d)
    uint8 codes → packed rows, byte-equal to ``sq_pack``."""
    n, d = q.shape
    if codec == "sq8":
        return q
    step = 2 if codec == "sq4" else 4
    if d % step:
        q = torch.cat([q, q.new_zeros((n, step - d % step))], 1)
    if codec == "sq4":
        return q[:, 0::2] | (q[:, 1::2] << 4)
    g = q.reshape(n, -1, 4).to(torch.int32)
    b0 = (g[..., 0] << 2) | (g[..., 1] >> 4)
    b1 = ((g[..., 1] & 15) << 4) | (g[..., 2] >> 2)
    b2 = ((g[..., 2] & 3) << 6) | g[..., 3]
    return torch.stack([b0, b1, b2], -1).reshape(n, -1).to(torch.uint8)


def sq_unpack_host(packed: np.ndarray, d: int, codec: str) -> np.ndarray:
    if codec == "sq4":
        return sq4_unpack_host(packed, d)
    if codec == "sq6":
        return sq6_unpack_host(packed, d)
    return packed                                    # sq8: already (n, d)


def sq_row_sums(codes: np.ndarray, d: int, codec: str) -> np.ndarray:
    """Host-side per-row Σ_d c_d fp32 (raw code sum) for the recentred
    int8 scans, chunked like sq_row_norms."""
    n = codes.shape[0]
    rs = np.empty((n,), np.float32)
    step = max(1, (1 << 27) // max(d, 1))
    for i in range(0, n, step):
        c = sq_unpack_host(codes[i:i + step], d, codec)
        rs[i:i + step] = c.astype(np.float32).sum(axis=1)
    return rs


def sq_row_norms(codes: np.ndarray, scale: np.ndarray, d: int,
                 codec: str) -> np.ndarray:
    """Host-side per-row Σ_d (scale_d c_d)² fp32 for the int8 scans,
    computed in ≤512 MB staging chunks (codes may be bit-packed)."""
    n = codes.shape[0]
    rn = np.empty((n,), np.float32)
    s2 = (np.asarray(scale) * np.asarray(scale)).astype(np.float32)
    step = max(1, (1 << 27) // max(d, 1))
    for i in range(0, n, step):
        c = sq_unpack_host(codes[i:i + step], d, codec).astype(np.float32)
        rn[i:i + step] = (c * c) @ s2
    return rn


# --- device unpack and decode ----------------------------------------------

def sq_unpack(packed: torch.Tensor, codec: str) -> torch.Tensor:
    """(n, w) packed uint8 rows → (n, sq_row_codes(w)) uint8 codes in
    dimension order (the pad codes of the packing included)."""
    n = packed.shape[0]
    if codec == "sq4":
        return torch.stack([packed & 15, packed >> 4], -1).reshape(n, -1)
    if codec == "sq6":
        g = packed.reshape(n, -1, 3)
        b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
        return torch.stack([b0 >> 2, ((b0 & 3) << 4) | (b1 >> 4),
                            ((b1 & 15) << 2) | (b2 >> 6), b2 & 63],
                           -1).reshape(n, -1)
    return packed


def sq_decode(codes: torch.Tensor, vmin: torch.Tensor, scale: torch.Tensor,
              codec: str) -> torch.Tensor:
    """Packed codes (n, w) → (n, d) fp32 ``c·scale + vmin``; a float
    codec's (n, 2·d) bytes → its rows (``vmin`` / ``scale`` unused)."""
    if codec in FLOAT_CODECS:
        return codes.contiguous().view(float_codec_dtype(codec)).to(
            torch.float32)
    d = vmin.shape[0]
    c = sq_unpack(codes, codec)[:, :d]
    return c.to(torch.float32) * scale[None, :] + vmin[None, :]


def sq_unpack_i8(packed: torch.Tensor, d: int, codec: str) -> torch.Tensor:
    """Packed rows → (n, d) int8 shifted codes c − SQ_INT8_SHIFT[codec]."""
    c = sq_unpack(packed, codec)[:, :d].to(torch.int16)
    return (c - SQ_INT8_SHIFT[codec]).to(torch.int8)


def sq_query_digits(u: torch.Tensor):
    """Two-digit int8 quantization of the query vectors u (15 bits):
    recentred by the per-query mean μ, ũ = u − μ ≈ su2·(128·hi + lo) with
    hi ∈ [−127, 127] and lo ∈ [−64, 64] (the JAX package's
    ``sq_query_digits``: one int8 digit's noise swamps the distance gaps
    of near-duplicate rows in clustered corpora).

    Returns (hi (nq, d) int8, lo (nq, d) int8, su2 (nq,), mu (nq,),
    sum_ut (nq,) = Σũ)."""
    mu = u.mean(1)
    ut = u - mu[:, None]
    su2 = ut.abs().amax(1).clamp(min=1e-30) / 16256.0
    q15 = torch.round(ut / su2[:, None]).clamp(-16256, 16256)
    hi = torch.round(q15 / 128.0).clamp(-127, 127)
    lo = q15 - 128.0 * hi
    return (hi.to(torch.int8), lo.to(torch.int8), su2, mu, ut.sum(1))


# --- the standalone index's scans ------------------------------------------

def _scan_blocks(nq: int, d: int) -> tuple[int, int]:
    """(q_block, c_block) of the SQ scans: every query at once, so a chunk
    is decoded once, and as many corpus rows as keep the (nq, c) score
    tile and the (c, d) decoded rows near 2^26 floats, a multiple of
    128."""
    return max(nq, 1), max(128, ((1 << 26) // max(nq, d, 1)) // 128 * 128)


def sq_search(codes, nvalid, vmin, scale, xq, mask, metric_arg=0.0, *, k,
              metric, codec):
    """Decode + distance + running top-k over rows [0, nvalid) of a (cap,
    w) code buffer (``duckdb_faiss_ext_tpu/ops/sq.py::sq_search``): the
    Flat scan ``search_scan`` with each chunk decoded to fp32 and scored by
    ``pairwise_tile`` (TF32 only in fast mode, as every plain matmul of the
    package).  Returns (max-oriented scores (nq, k), positions (nq, k)
    int32): equal scores to the lower row, -inf / -1 where fewer than k
    rows are valid."""
    sim = metric in SIMILARITY_METRICS

    def tile(q0, q1, c0, c1):
        xc = sq_decode(codes[c0:c1], vmin, scale, codec)
        dist = pairwise_tile(xq[q0:q1], xc, metric, metric_arg)
        return dist if sim else -dist

    return search_scan(codes, nvalid, xq, k, metric, mask=mask, tile=tile,
                       blocks=_scan_blocks(xq.shape[0], vmin.shape[0]))


def int8_dots(a: torch.Tensor, codes: torch.Tensor, d: int, codec: str):
    """Exact (m, n) int32 dots of int8 rows ``a`` (m, d) with the shifted
    codes c − SQ_INT8_SHIFT of packed rows (n, w), by ``torch._int_mm``
    (int32 accumulation; on a card it takes m > 16 and d, n multiples of
    8, so both sides are zero-padded to that)."""
    c = sq_unpack_i8(codes, d, codec)
    m, n = a.shape[0], c.shape[0]
    dp = -(-d // 8) * 8
    a = F.pad(a, (0, dp - d, 0, max(32, -(-m // 8) * 8) - m))
    c = F.pad(c, (0, dp - d, 0, -(-n // 8) * 8 - n))
    return torch._int_mm(a, c.T)[:m, :n]


def sq_int8_search(codes, row_norm, row_sum, nvalid, vmin, scale, xq, mask,
                   *, k, k_scan, metric, codec):
    """Int8 scan of the quantized codecs for L2 / inner product
    (``duckdb_faiss_ext_tpu/ops/sq.py::sq_int8_search``): the query in two
    int8 digits of ũ = u − μ (``sq_query_digits``), exact int32 dots of
    each digit with the shifted codes, the JAX package's fp32 epilogue

        L2: −max(‖t‖² − 2·u·c + Σ(scale·c)², 0)    IP: q·vmin + u·c
        u·c = su2·(128·(hi·c') + lo·c') + shift·Σũ + μ·Σc

    and a running top ``k_scan``, whose rows are then decoded and rescored
    in fp32 (L2 in difference form) for the best k, equal scores to the
    pool's order.  ``row_norm`` / ``row_sum``: each row's Σ(scale·c)² and
    Σc.  Returns the ``sq_search`` convention."""
    from .sq_digits import int8_scores, query_digits

    nq, d = xq.shape
    w = codes.shape[1]
    q = query_digits(xq, vmin, scale, metric, codec, w, SQ_INT8_SHIFT[codec])
    digits = q.digits[:, :, :d].reshape(2 * nq, d)

    def tile(q0, q1, c0, c1):
        dots = int8_dots(digits[2 * q0:2 * q1], codes[c0:c1], d,
                         codec).reshape(q1 - q0, 2, -1)
        return int8_scores(dots[:, 0], dots[:, 1],
                           q.scalars[q0:q1, None, :], row_sum[None, c0:c1],
                           row_norm[None, c0:c1], metric)

    best_s, best_p = search_scan(codes, nvalid, xq, k_scan, metric,
                                 mask=mask, tile=tile,
                                 blocks=_scan_blocks(nq, d))
    xs = sq_decode(codes[best_p.clamp(min=0).reshape(-1).long()], vmin,
                   scale, codec).reshape(nq, k_scan, d)
    if metric == "INNER_PRODUCT":
        s2 = (xs * xq[:, None, :]).sum(-1)
    else:
        diff = xs - xq[:, None, :]
        s2 = -(diff * diff).sum(-1)
    s2 = torch.where(best_p >= 0, s2, _NEG_INF)
    s, sel = exact_topk(s2, k)
    return s, best_p.gather(1, sel).masked_fill(torch.isneginf(s), -1)
