"""Global runtime configuration.

``precision_mode`` selects the float32 matmul mode of the plain torch paths:

* ``"parity"`` — full fp32: TF32 is switched off for both cuBLAS matmuls
  and cuDNN (the counterpart of ``lax.Precision.HIGHEST``), required to
  match the reference's fp32 BLAS distances (the golden-value tests,
  test/sql/faiss.test:16-38).
* ``"fast"``   — TF32 allowed.  The hand-written Flat kernel
  (ops/flat_topk.py) is the same in both modes: 3xTF32 tensor-core scores
  select candidates, which it rescores in fp32 FMA, so its results are
  fp32 either way.

``device`` names where every index keeps its corpus and runs its search.
It defaults to ``"cuda"``; asking for ``"cuda"`` on a machine without a
card raises (``resolve_device``) instead of carrying on on the CPU.

``sq_dot`` selects how IVF,SQ8/SQ4/SQ6 searches score their codes:
``"auto"`` takes the int8 digit-dot path (the padded code layout and its
kernels, then an exact fp32 rerank) in fast mode and the fp32 decode path
in parity mode; ``"int8"`` / ``"decode"`` force one path
(``sq_int8_active``).  A device-resident index (``faiss_add_device``)
scans its padded layout with the int8 kernels in both modes.

``pairs_impl`` selects the pair-tile kernels of large IVF batches:
``"grid"`` (the default) takes K7 / K3 (ops/ivf_pairs.py,
ops/ivf_sq_pairs.py), ``"mega"`` their pipelined forms K10 / K9
(ops/ivf_pairs_mega.py, ops/ivf_sq_pairs_mega.py), the same function;
any other value means grid, as in the JAX package.

The JAX package's TPU lowering knobs beside them (``sq_digit_dtype``,
``spill_impl``, ``spill_pallas_min``, ``fused_dispatch``,
``spill_int8_via``, ``query_wire``) have no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

_PRECISIONS = ("parity", "fast")


@dataclasses.dataclass
class Config:
    precision_mode: str = "parity"
    #: device holding corpora and running searches: "cuda" or "cpu"
    device: str = "cuda"
    #: minimum padded corpus capacity (power of two)
    min_capacity: int = 128
    #: minimum padded query-batch bucket
    min_query_bucket: int = 8
    #: IVF,SQ scoring: "auto" = int8 digit dots in fast mode, fp32 decode
    #: in parity mode; "int8" / "decode" force one path
    sq_dot: str = "auto"
    #: pair-tile kernels: "grid" (K7 / K3) or "mega" (K10 / K9)
    pairs_impl: str = "grid"


config = Config()


def _apply_precision(mode: str) -> None:
    tf32 = mode == "fast"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


_apply_precision(config.precision_mode)


def set_precision(mode: str) -> None:
    if mode not in _PRECISIONS:
        raise ValueError(f"precision mode must be one of {sorted(_PRECISIONS)}")
    config.precision_mode = mode
    _apply_precision(mode)


def set_sq_dot(mode: str) -> None:
    if mode not in ("auto", "int8", "decode"):
        raise ValueError("sq dot mode must be auto, int8, or decode")
    config.sq_dot = mode


def sq_int8_active() -> bool:
    """Whether IVF,SQ searches take the int8 digit-dot path right now."""
    if config.sq_dot == "int8":
        return True
    if config.sq_dot == "decode":
        return False
    return config.precision_mode != "parity"


@contextlib.contextmanager
def full_fp32():
    """Run the enclosed float32 matmuls without TF32 whatever the precision
    mode (the JAX package's ``lax.Precision.HIGHEST`` for one call): k-means
    training and list assignment need full fp32 in both modes."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def set_device(device: str) -> None:
    """Select where new searches run ("cuda" or "cpu"); raises when CUDA is
    asked for and no card is present."""
    resolve_device(device)
    config.device = device


def resolve_device(device: str | None = None) -> torch.device:
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "duckdb_faiss_ext_tpu_torch: device 'cuda' was requested but "
            "torch.cuda.is_available() is False; set config.device = 'cpu' "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def next_capacity(n: int) -> int:
    """Device-buffer capacity schedule: powers of two up to 1M rows
    (amortised growth), then 1M-row increments — pow2 padding would waste
    up to 2x device memory at 10M+ rows."""
    n = int(n)
    if n <= (1 << 20):
        return next_pow2(max(n, 1))
    step = 1 << 20
    return step * -(-n // step)


def pad_rows(arr, target: int, fill=0.0):
    """Pad (n, ...) numpy array with fill rows up to target rows."""
    n = arr.shape[0]
    if n == target:
        return arr
    pad = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)
