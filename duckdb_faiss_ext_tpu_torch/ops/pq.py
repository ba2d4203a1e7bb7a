"""Product-quantization codec in plain torch: codebook training, encoding,
decoding, the standalone fused search, and the anisotropic pair.

The counterpart of ``duckdb_faiss_ext_tpu/ops/pq.py`` (faiss::IndexPQ as the
reference's factory strings reach it, ``PQm[xb]``, SearchParametersPQ
defaults at src/faiss_extension.cpp:704-708).  The JAX package ran all of it
as XLA, outside any ``pallas_call``, so it is plain torch here too.

* Training is one k-means per subspace (the port's ops/kmeans.py, seeded
  ``seed + i``); the JAX package's ``vmap`` over the M subspaces is a loop.
* Encoding takes the argmin of ``‖x‖² − 2x·c + ‖c‖²`` per subspace, the
  JAX package's formula, so codes agree with its codes wherever the best
  and second-best costs are further apart than rounding.
* Decoding is a gather (codes → sub-centroids, concatenated).  The JAX
  package's one-hot matmul decode was a TPU workaround and is not ported.
* ``codec_*`` switch between PQ and the additive RQ codec (ops/rq.py) for
  every index that stores byte codes.
* ``pq_search`` is the standalone fused decode + distance + top-k chunk scan.
* The anisotropic (score-aware) pair, ScaNN's loss (Guo et al., ICML 2020):
  L(x, c) = eta·‖r_par‖² + ‖r_orth‖², r = x − c, with a closed-form
  (dsub, dsub) solve per centroid (``torch.linalg.solve`` batched over the
  clusters where the JAX package vmapped it).

Training and encoding run in full fp32 (TF32 off) in both precision modes.
Initial centroids come from the port's generator, not the JAX package's, so
the two packages train different codebooks from the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import full_fp32
from .distance import pairwise_tile
from .flat_search import SIMILARITY_METRICS, exact_topk, topk_ordered
from .kmeans import DEFAULT_NITER, DEFAULT_SEED, kmeans_fit

_NEG_INF = float("-inf")


def _subspace(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) → (m, n, d // m) views of the subspaces."""
    n, d = x.shape
    return x.reshape(n, m, d // m).transpose(0, 1)


def pq_train(x: torch.Tensor, m: int, ksub: int, niter: int = DEFAULT_NITER,
             seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Train PQ codebooks on (n, d) fp32 data, d divisible by m: one k-means
    per subspace, seeded ``seed + i``.  Returns (m, ksub, dsub) fp32."""
    xsub = _subspace(x, m)
    return torch.stack([
        kmeans_fit(xsub[i].contiguous(), ksub, niter=niter, seed=seed + i)[0]
        for i in range(m)])


def pq_encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Encode (n, d) → (n, m) uint8 codes: the nearest sub-centroid of each
    subspace by ``‖x‖² − 2x·c + ‖c‖²`` (first index on ties)."""
    m = codebooks.shape[0]
    xsub = _subspace(x, m)
    codes = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    with full_fp32():
        for i in range(m):
            xs, cb = xsub[i], codebooks[i]
            xn = (xs * xs).sum(1, keepdim=True)
            cn = (cb * cb).sum(1)[None, :]
            codes[:, i] = (xn - 2.0 * (xs @ cb.T) + cn).argmin(1).to(
                torch.uint8)
    return codes


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Decode (c, m) uint8 codes → (c, d) fp32: the selected sub-centroids
    concatenated."""
    m, _, dsub = codebooks.shape
    sub = torch.arange(m, device=codes.device)
    return codebooks[sub, codes.long()].reshape(codes.shape[0], m * dsub)


def codec_decode(codes, codebooks, codec: str = "pq") -> torch.Tensor:
    """Decode byte codes with the named codec: "pq" (subspace concat) or
    "rq" (additive sum, ops/rq.py)."""
    if codec == "rq":
        from .rq import rq_decode

        return rq_decode(codes, codebooks)
    return pq_decode(codes, codebooks)


def codec_encode(x, codebooks, codec: str = "pq", *, beam=None):
    """``beam`` applies to the RQ encoder only (None → its default)."""
    if codec == "rq":
        from .rq import rq_encode

        return rq_encode(x, codebooks, **({} if beam is None
                                          else {"beam": beam}))
    return pq_encode(x, codebooks)


def codec_train(x, m: int, ksub: int, codec: str = "pq", *,
                niter: int = DEFAULT_NITER, seed: int = DEFAULT_SEED):
    if codec == "rq":
        from .rq import rq_train

        return rq_train(x, m, ksub, niter=niter, seed=seed)
    return pq_train(x, m, ksub, niter=niter, seed=seed)


def pq_search(codes, nvalid, codebooks, xq, mask, metric_arg, *, k, metric,
              chunk, codec="pq"):
    """Fused decode + distance + top-k scan over (cap, m) byte codes, in
    chunks of ``chunk`` rows; rows at or past ``nvalid`` are never scanned.
    ``mask`` is a (cap,) bool row mask or None.  Returns max-oriented
    (scores (nq, k), positions (nq, k) int32), (-inf, -1) where missing;
    equal scores rank by ascending position."""
    nq = xq.shape[0]
    sim = metric in SIMILARITY_METRICS
    dev = xq.device
    best_s = torch.full((nq, k), _NEG_INF, dtype=torch.float32, device=dev)
    best_p = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    n_scan = min(codes.shape[0], int(nvalid))
    for start in range(0, n_scan, chunk):
        xc = codec_decode(codes[start:start + chunk], codebooks, codec)
        dist = pairwise_tile(xq, xc, metric, metric_arg)
        rowid = start + torch.arange(xc.shape[0], device=dev)
        valid = rowid < n_scan
        if mask is not None:
            valid = valid & mask[start:start + chunk]
        score = torch.where(valid[None, :], dist if sim else -dist, _NEG_INF)
        local_s, local_i = exact_topk(score, min(k, xc.shape[0]))
        best_s, best_p = topk_ordered(torch.cat([best_s, local_s], 1),
                                      torch.cat([best_p, start + local_i], 1),
                                      k)
    best_p = torch.where(torch.isneginf(best_s), -1, best_p)
    return best_s, best_p.to(torch.int32)


# --- anisotropic (score-aware) PQ ---------------------------------------------
#
# Assignment cost ‖r‖² + (eta−1)·(r·x̂)², r = x − c, x̂ the unit anisotropy
# axis (the datapoint itself, or for IVF residual storage the ORIGINAL
# datapoint).  The update solves [n_j I + (eta−1) Σ x̂x̂ᵀ] c_j = Σx +
# (eta−1) Σ x̂(x̂·x) per cluster; eta = 1 reduces exactly to k-means.

def _f32(eta) -> float:
    """eta rounded to float32, as the JAX package passes it."""
    return float(np.float32(eta))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp((v * v).sum(1, keepdim=True),
                                      min=1e-20))


def aniso_cost(xs, xhat, centroids, eta) -> torch.Tensor:
    """(n, ksub) score-aware cost ‖x−c‖² + (eta−1)((x−c)·x̂)²."""
    xn = (xs * xs).sum(1, keepdim=True)
    cn = (centroids * centroids).sum(1)[None, :]
    sqdist = xn - 2.0 * (xs @ centroids.T) + cn
    rpar = (xs * xhat).sum(1, keepdim=True) - xhat @ centroids.T
    return sqdist + (_f32(eta) - 1.0) * rpar * rpar


def aniso_step(xs, xhat, centroids, eta) -> torch.Tensor:
    """One anisotropic Lloyd step: score-aware assignment, then the closed
    form per centroid; an empty cluster keeps its centroid."""
    dsub = xs.shape[1]
    ksub = centroids.shape[0]
    w = _f32(eta) - 1.0
    labels = aniso_cost(xs, xhat, centroids, eta).argmin(1)
    counts = torch.bincount(labels, minlength=ksub).to(torch.float32)
    zeros = torch.zeros((ksub, dsub), dtype=torch.float32, device=xs.device)
    sum_x = zeros.index_add(0, labels, xs)
    proj_x = (xs * xhat).sum(1, keepdim=True)
    sum_xw = zeros.index_add(0, labels, xhat * proj_x)
    outer = torch.zeros((ksub, dsub * dsub), dtype=torch.float32,
                        device=xs.device).index_add_(
        0, labels, (xhat[:, :, None] * xhat[:, None, :]).reshape(-1,
                                                               dsub * dsub))
    eye = torch.eye(dsub, dtype=torch.float32, device=xs.device)
    a = counts[:, None, None] * eye + w * outer.reshape(ksub, dsub, dsub)
    b = sum_x + w * sum_xw
    empty = counts < 0.5
    a = torch.where(empty[:, None, None], eye, a)
    b = torch.where(empty[:, None], centroids, b)
    return torch.linalg.solve(a, b[:, :, None])[:, :, 0]


def pq_train_anisotropic(x, m: int, ksub: int, eta: float,
                         niter: int = DEFAULT_NITER, seed: int = DEFAULT_SEED,
                         dirs=None) -> torch.Tensor:
    """Anisotropic PQ codebooks (m, ksub, dsub): k-means under the
    score-aware loss, per subspace, from ``ksub`` distinct points drawn with
    the port's generator seeded ``seed + i``.  ``dirs`` (n, d) sets the
    anisotropy axis per point (default: the points themselves)."""
    dirs = x if dirs is None else dirs
    xsub, dirsub = _subspace(x, m), _subspace(dirs, m)
    n = x.shape[0]
    books = []
    with full_fp32():
        for i in range(m):
            xs = xsub[i].contiguous()
            xhat = _unit(dirsub[i])
            g = torch.Generator(device="cpu").manual_seed(int(seed) + i)
            cents = xs[torch.randperm(n, generator=g)[:ksub].to(x.device)]
            for _ in range(int(niter)):
                cents = aniso_step(xs, xhat, cents, eta)
            books.append(cents)
    return torch.stack(books)


def pq_encode_anisotropic(x, codebooks, eta, *, dirs=None) -> torch.Tensor:
    """Score-aware encoding matching pq_train_anisotropic's loss: the
    sub-codeword minimising ‖x−c‖² + (eta−1)((x−c)·x̂)²."""
    m = codebooks.shape[0]
    dirs = x if dirs is None else dirs
    xsub, dirsub = _subspace(x, m), _subspace(dirs, m)
    codes = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    with full_fp32():
        for i in range(m):
            cost = aniso_cost(xsub[i], _unit(dirsub[i]), codebooks[i], eta)
            codes[:, i] = cost.argmin(1).to(torch.uint8)
    return codes
