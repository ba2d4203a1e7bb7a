"""Pairwise distance tiles for all nine metrics, in plain torch.

The counterpart of FAISS's distance kernels (BLAS sgemm for L2/IP plus
scalar loops in extra_distances for the rest; used by the reference via
``Index::search``, src/faiss_extension.cpp:631).

Every metric is computed as a (Q, C) tile of scores from a (Q, D) query
block and a (C, D) corpus block.

* ``L2`` and ``INNER_PRODUCT`` are one matmul.  L2 uses the
  ``‖x‖² − 2·x·yᵀ + ‖y‖²`` decomposition with a clamp at 0; FAISS's
  METRIC_L2 is the *squared* L2 distance — kept.  The Flat index sends
  these two metrics to the hand-written kernel (ops/flat_topk.py) on the
  card; this tile serves the plain scan.
* The seven remaining metrics are elementwise (Q, C, D) reductions.
  Callers bound C so the broadcast tile stays small.

All computations are fp32; the matmul precision follows
``utils.config.set_precision`` (TF32 off in parity mode).
"""

from __future__ import annotations

import torch

# Metrics whose pairwise tile is a matmul.
MXU_METRICS = ("INNER_PRODUCT", "L2")


def pairwise_tile(xq: torch.Tensor, xb: torch.Tensor, metric: str,
                  metric_arg: float = 0.0) -> torch.Tensor:
    """(Q, C) fp32 distances (similarities for IP/Jaccard)."""
    if metric == "INNER_PRODUCT":
        return xq @ xb.T
    if metric == "L2":
        qn = (xq * xq).sum(-1, keepdim=True)          # (Q, 1)
        bn = (xb * xb).sum(-1)[None, :]               # (1, C)
        return torch.clamp(qn - 2.0 * (xq @ xb.T) + bn, min=0.0)
    return elementwise_scores(xq[:, None, :], xb[None, :, :], metric,
                              metric_arg)


def elementwise_scores(x, y, metric, metric_arg=0.0):
    """Elementwise-metric distances over any broadcastable operand pair
    whose last axis is the vector dimension."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if metric == "L1":
        return (x - y).abs().sum(-1)
    if metric == "Linf":
        return (x - y).abs().amax(-1)
    if metric == "Lp":
        # FAISS sums |x-y|^p without the 1/p root; p = Index::metric_arg.
        return ((x - y).abs() ** float(metric_arg)).sum(-1)
    if metric == "Canberra":
        num = (x - y).abs()
        den = x.abs() + y.abs()
        return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                           zero).sum(-1)
    if metric == "BrayCurtis":
        num = (x - y).abs().sum(-1)
        den = (x + y).abs().sum(-1)
        return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                           zero)
    if metric == "JensenShannon":
        # 0.5 * Σ x·log(2x/(x+y)) + y·log(2y/(x+y)); zero terms where the
        # numerator mass is zero (the KL convention FAISS uses).
        m = x + y

        def safe(a):
            ratio = (torch.where(a > 0, 2.0 * a, 1.0)
                     / torch.where(m > 0, m, 1.0))
            return torch.where(a > 0, a * torch.log(ratio), zero)

        return 0.5 * (safe(x) + safe(y)).sum(-1)
    if metric == "Jaccard":
        # Similarity: Σ min / Σ max (FAISS treats Jaccard like IP: max-heap).
        num = torch.minimum(x, y).sum(-1)
        den = torch.maximum(x, y).sum(-1)
        return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                           zero)
    raise ValueError(f"unknown metric {metric}")
