"""Query digits, the plain digit dot and the score epilogue of the int8
IVF,SQ scans (K4).

The counterpart of ``duckdb_faiss_ext_tpu/ops/sq_digits.py``
(``sq_block_digit_dot``), the unpack-and-dot every int8 SQ kernel runs: the
per-query list scan (K2, ops/ivf_sq_scan.py), the pair tiles (K3,
ops/ivf_sq_pairs.py) and the spill scan (K5, ops/sq_spill.py).  On the card
it is the ``__device__`` code of ``csrc/sq_digits.cuh``; here are its plain
torch version and what the three wrappers share around it.

Scoring (``duckdb_faiss_ext_tpu/ops/sq.py::sq_int8_search``): with
t = q − vmin and u = t⊙scale (L2), or u = q⊙scale (inner product),

    u·c  = su2·(128·(hi·c') + lo·c') + c0 + μ·Σc,   c' = c − shift
    IP:  base + u·c            (base = q·vmin)
    L2:  −max(base − 2·u·c + Σ(scale·c)², 0)     (base = ‖t‖²)

where hi, lo are the query's two int8 digits (ops/sq.py::sq_query_digits)
and c0 = shift·Σũ.  Inside the kernels sq8 codes enter as c ⊕ 0x80 =
c − 128 and sq4 / sq6 codes raw (``KERNEL_SHIFT``).

The digits stay in dimension order, zero-padded to ``digit_width`` (whole
words of four, so a pad code meets a zero digit).  The TPU kernels' bf16
cast of the dot operands and their sq4 even/odd and sq6 plane-major query
packing followed from Mosaic layouts and are not ported.

Exactness: a digit dot is an integer below 127·128·d in magnitude, so the
plain version takes it in float64 (exact below 2^53, on the CPU and on the
card alike) where the kernels take it in int32; both then round it to fp32
and apply ``int8_scores`` in the JAX package's order, without fused
multiply-adds, so kernel and plain version agree to the last bit of the
epilogue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils.config import full_fp32
from .sq import sq_query_digits, sq_row_codes, sq_unpack

#: code shift inside the kernels: sq8 codes enter as c ⊕ 0x80 = c − 128,
#: sq4 and sq6 codes raw
KERNEL_SHIFT = {"sq8": 128, "sq4": 0, "sq6": 0}

#: codec numbers of the kernels' C interface
CODEC_ID = {"sq8": 0, "sq4": 1, "sq6": 2}

METRICS = ("INNER_PRODUCT", "L2")


class Digits(NamedTuple):
    """A query batch in the form the int8 scans take."""
    digits: torch.Tensor   # (nq, 2, digit_width) int8: hi, lo
    scalars: torch.Tensor  # (nq, 4) fp32: su2, c0, base, mu


def digit_width(w: int, codec: str) -> int:
    """Digits a query needs against packed rows of w bytes: the row's codes
    rounded up to whole words of four."""
    return 4 * -(-sq_row_codes(w, codec) // 4)


def query_digits(xq: torch.Tensor, vmin: torch.Tensor, scale: torch.Tensor,
                 metric: str, codec: str, w: int, shift: int) -> Digits:
    """Digits and per-query scalars of a query batch (nq, d) fp32, for codes
    that enter the dots shifted by ``shift``."""
    if metric == "INNER_PRODUCT":
        u = xq * scale[None, :]
        with full_fp32():
            base = xq @ vmin
    else:
        t = xq - vmin[None, :]
        u = t * scale[None, :]
        base = (t * t).sum(1)
    hi, lo, su2, mu, sum_ut = sq_query_digits(u)
    c0 = shift * sum_ut if shift else torch.zeros_like(su2)
    pad = digit_width(w, codec) - hi.shape[1]
    digits = F.pad(torch.stack([hi, lo], 1), (0, pad))
    return Digits(digits.contiguous(),
                  torch.stack([su2, c0, base, mu], 1).contiguous())


def unpack_f64(codes: torch.Tensor, codec: str, shift: int,
               width: int) -> torch.Tensor:
    """Packed rows (..., w) uint8 → (..., width) float64 codes c − shift in
    dimension order (pad columns past the row's codes are −shift: they
    meet zero digits)."""
    lead, w = codes.shape[:-1], codes.shape[-1]
    c = sq_unpack(codes.reshape(-1, w), codec).to(torch.float64) - shift
    c = F.pad(c, (0, width - c.shape[1]), value=-float(shift))
    return c.reshape(*lead, width)


def digit_dots(codes: torch.Tensor, digits: torch.Tensor, codec: str,
               shift: int) -> torch.Tensor:
    """The plain digit dot (K4): rows (b, r, w) uint8 against digit rows
    (b, s, width) int8 → exact (b, s, r) float64 dots."""
    c = unpack_f64(codes, codec, shift, digits.shape[-1])
    return torch.bmm(digits.to(torch.float64), c.transpose(1, 2))


def int8_scores(dot_hi, dot_lo, scalars, rs, rn, metric: str):
    """The fp32 epilogue from the exact dots, in the JAX package's order.
    ``scalars`` (..., 4) broadcasts against the dots; ``rs`` / ``rn`` per
    row (``rn`` unused for inner product)."""
    su2, c0, base, mu = scalars.unbind(-1)
    utc = su2 * (128.0 * dot_hi.to(torch.float32)
                 + dot_lo.to(torch.float32))
    uc = utc + c0 + mu * rs
    if metric == "INNER_PRODUCT":
        return base + uc
    return -(base - 2.0 * uc + rn).clamp(min=0.0)
