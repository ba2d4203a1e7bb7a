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

The int8 scans score a query against codes with two int8 digits of the
query (``sq_query_digits``) and exact integer dots; ``SQ_INT8_SHIFT``
recentres the codes into int8 range.  The float codecs (``SQfp16``,
``SQbf16``) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

#: quantization levels per codec (code range [0, levels])
SQ_LEVELS = {"sq8": 255, "sq4": 15, "sq6": 63}

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
    """Packed codes (n, w) → (n, d) fp32 ``c·scale + vmin``."""
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
