"""Residual-quantizer codec in plain torch: additive multi-stage codebooks
(faiss ``RQ{M}x{b}``).

The counterpart of ``duckdb_faiss_ext_tpu/ops/rq.py`` (faiss::
IndexResidualQuantizer as the reference's verbatim index_factory pass-through
reaches it, src/faiss_extension.cpp:154-155).  Every stage holds
full-dimension codewords; the reconstruction is their sum, dec(c) =
Σ_s cb[s][c_s], taken in stage order s = 0 … M−1.

* Training is sequential residual k-means: stage s fits ``ksub`` codewords
  (the port's ops/kmeans.py, seeded ``seed + s``) to what stages < s left.
* Encoding is a batched beam search (beam 1 = greedy): each stage scores
  every beam entry's residual against the stage codebook with one matmul and
  keeps the best ``beam`` of the beam·ksub expansions, equal costs to the
  lower flat index (as ``lax.top_k`` breaks them, through ``exact_topk``);
  the code of the entry with the smallest final residual wins.
* Decoding is one gather per stage, summed.  The JAX package's one-hot
  matmul decode was a TPU workaround and is not ported.

Everything runs in full fp32 (TF32 off) in both precision modes.
"""

from __future__ import annotations

import torch

from ..utils.config import full_fp32
from .flat_search import exact_topk
from .kmeans import DEFAULT_NITER, DEFAULT_SEED, kmeans_fit


def rq_train(x: torch.Tensor, m: int, ksub: int, niter: int = DEFAULT_NITER,
             seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Train additive codebooks on (n, d) fp32 data → (m, ksub, d)."""
    resid = x
    books = []
    for stage in range(m):
        cb, labels = kmeans_fit(resid, ksub, niter=niter, seed=seed + stage)
        books.append(cb)
        resid = resid - cb[labels]
    return torch.stack(books)


def rq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Decode (c, m) uint8 codes → (c, d) fp32: the stage codewords summed
    in stage order."""
    m, _, d = codebooks.shape
    idx = codes.long()
    out = torch.zeros((codes.shape[0], d), dtype=torch.float32,
                      device=codes.device)
    for stage in range(m):
        out = out + codebooks[stage][idx[:, stage]]
    return out


def rq_encode(x: torch.Tensor, codebooks: torch.Tensor, *,
              beam: int = 4) -> torch.Tensor:
    """Encode (n, d) → (n, m) uint8 codes with a batched beam search
    (``beam`` clamped to [1, ksub])."""
    n, d = x.shape
    m, ksub, _ = codebooks.shape
    beam = max(1, min(int(beam), ksub))
    with full_fp32():
        cb0 = codebooks[0]
        d0 = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ cb0.T)
              + (cb0 * cb0).sum(1)[None, :])
        _, pick = exact_topk(-d0, beam)                    # (n, B)
        resid = x[:, None, :] - cb0[pick]                  # (n, B, d)
        codes = pick[:, :, None]                           # (n, B, 1)
        for stage in range(1, m):
            cb = codebooks[stage]
            rn = (resid * resid).sum(2, keepdim=True)
            cn = (cb * cb).sum(1)[None, None, :]
            dist = (rn - 2.0 * (resid @ cb.T) + cn).reshape(n, beam * ksub)
            _, flat = exact_topk(-dist, beam)
            parent = flat // ksub
            code = flat % ksub
            resid = resid.gather(1, parent[:, :, None].expand(-1, -1, d)) \
                - cb[code]
            codes = torch.cat([codes.gather(1, parent[:, :, None].expand(
                -1, -1, codes.shape[2])), code[:, :, None]], 2)
        best = (resid * resid).sum(2).argmin(1)
    return codes[torch.arange(n, device=x.device), best].to(torch.uint8)
