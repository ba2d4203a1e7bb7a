"""Lloyd's k-means in plain torch: the coarse-quantizer training of IVF.

The counterpart of ``duckdb_faiss_ext_tpu/ops/kmeans.py`` (faiss::Clustering
as ``Index::train`` drives it, src/faiss_extension.cpp:396,583).  Assignment
is a chunked fp32 distance matmul + ``argmin``; the update is an
``index_add_`` segment sum.  Both run on the device the data lies on, in
full fp32 (TF32 off) whatever the precision mode, as the JAX package trains
at ``lax.Precision.HIGHEST``.

Kept from the JAX package: a fixed iteration count; empty clusters keep
their previous centroid; the optional ``balance`` penalty on over-full
clusters; spherical renormalisation for inner-product indexes; FAISS's
subsample of at most 256 points per centroid.

Deviation: the initial centroids are ``k`` distinct points drawn with a
``torch.Generator`` seeded with ``seed`` (``torch.randperm``), not the
JAX package's ``jax.random.gumbel`` top-k.  The two generators give
different samples from the same seed, so the two packages train different
centroids from the same data; parity tests carry the JAX package's trained
state across (``io/convert.from_reference`` or a checkpoint) instead.
"""

from __future__ import annotations

import torch

from ..utils.config import full_fp32

DEFAULT_NITER = 25       # faiss::ClusteringParameters::niter
DEFAULT_SEED = 1234      # faiss::ClusteringParameters::seed
MAX_POINTS_PER_CENTROID = 256  # faiss subsamples beyond this


def _chunk(k: int) -> int:
    """Rows per assignment step: bounds the (rows, k) fp32 distance tile to
    ~512 MB."""
    return max(1024, min(65536, (1 << 27) // max(k, 1)))


def sq_distances(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, k) squared L2 distances by the ‖x‖² − 2x·c + ‖c‖² expansion."""
    xn = (x * x).sum(1, keepdim=True)
    cn = (centroids * centroids).sum(1)[None, :]
    return xn - 2.0 * (x @ centroids.T) + cn


def assign_labels(x: torch.Tensor, centroids: torch.Tensor,
                  penalty: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest centroid of every row (first index on ties), optionally with
    a per-centroid additive ``penalty``; (n,) int64."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    step = _chunk(centroids.shape[0])
    with full_fp32():
        for s in range(0, x.shape[0], step):
            d2 = sq_distances(x[s:s + step], centroids)
            if penalty is not None:
                d2 = d2 + penalty[None, :]
            out[s:s + step] = d2.argmin(1)
    return out


def _mean_min_distance(x, centroids) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    step = _chunk(centroids.shape[0])
    with full_fp32():
        for s in range(0, x.shape[0], step):
            total += sq_distances(x[s:s + step], centroids).min(1).values.sum()
    return total / max(x.shape[0], 1)


def lloyd_step(x, centroids, counts, *, balance=0.0, spherical=False):
    """One iteration: (penalised) assignment, then the centroid update.
    ``counts`` are the previous iteration's cluster sizes (the balance
    penalty's input).  Returns (new centroids, new counts float32)."""
    k = centroids.shape[0]
    if balance > 0.0:
        # Penalise over-full clusters on the scale of the mean assigned
        # distance, with the over-fullness factor clamped (see the JAX
        # package's _kmeans_fit for why the scale matters).
        navg = max(x.shape[0] / k, 1.0)
        scale = _mean_min_distance(x, centroids) * 0.5
        over = (counts / navg - 1.0).clamp(0.0, 2.0)
        labels = assign_labels(x, centroids, balance * scale * over)
    else:
        labels = assign_labels(x, centroids)
    sums = torch.zeros_like(centroids).index_add_(0, labels, x)
    new_counts = torch.bincount(labels, minlength=k).to(torch.float32)
    new = sums / new_counts.clamp(min=1.0)[:, None]
    if spherical:
        # faiss Level1Quantizer::train_q1 trains spherically for
        # METRIC_INNER_PRODUCT: renormalise every iteration.
        new = new / new.norm(dim=1, keepdim=True).clamp(min=1e-20)
    new = torch.where((new_counts > 0)[:, None], new, centroids)
    return new, new_counts


def kmeans_fit(x: torch.Tensor, k: int, niter: int = DEFAULT_NITER,
               seed: int = DEFAULT_SEED, balance: float = 0.0,
               spherical: bool = False):
    """Fit k centroids on (n, d) fp32 data (n ≥ k).  Returns (centroids
    (k, d), labels (n,) int64) on the data's device."""
    n = x.shape[0]
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    init = torch.randperm(n, generator=g)[:k].to(x.device)
    centroids = x[init].clone()
    counts = torch.full((k,), max(n / k, 1.0), dtype=torch.float32,
                        device=x.device)
    for _ in range(int(niter)):
        centroids, counts = lloyd_step(x, centroids, counts,
                                       balance=balance, spherical=spherical)
    return centroids, assign_labels(x, centroids)


def subsample_for_training(n: int, k: int) -> int:
    """FAISS trains on at most k*max_points_per_centroid points."""
    return min(n, k * MAX_POINTS_PER_CENTROID)
