"""Brute-force k-NN search in plain torch: blocked distance scan + top-k.

The counterpart of the reference's hot path — ``Index::search`` under
``faiss_lock`` (src/faiss_extension.cpp:629-638), which in FAISS is a BLAS
GEMM plus a per-query heap select.  On the card the Flat index sends L2 and
inner product to the hand-written kernel (ops/flat_topk.py); this module is
the path for the seven elementwise metrics, for ``k > 1024``, for CPU
tensors, and the plain version the kernel is checked against.

Semantics mirrored from FAISS:
* Results are sorted best-first ("rank" order in the output schema); equal
  scores rank by ascending row position, so every path returns the same
  order.
* Fewer than k valid candidates → position -1 and a sentinel distance
  (+inf for distance metrics, -inf for similarity metrics).
* Similarity metrics (INNER_PRODUCT, Jaccard) select max; others select min.

``search_scan`` works on max-oriented scores (-inf = missing) and global
row positions.  An optional ``mask`` (bool per corpus row) implements
filtered search as a semi-join fused into the scan — the equivalent of
FAISS's IDSelector consulted inside scan loops
(src/faiss_extension.cpp:959,1008).
"""

from __future__ import annotations

import torch

from ..utils.config import next_pow2
from .distance import MXU_METRICS, pairwise_tile

# Metrics where larger is better (FAISS is_similarity_metric).
SIMILARITY_METRICS = frozenset({"INNER_PRODUCT", "Jaccard"})

_NEG_INF = float("-inf")
_LOW = 1 << 32
_INT64_MIN = torch.iinfo(torch.int64).min


def choose_blocks(cap: int, nq: int, d: int, metric: str,
                  k: int = 1) -> tuple[int, int]:
    """(q_block, c_block): the per-step tile is (q_block, c_block) fp32
    scores plus their int64 selection keys.  Matmul metrics bound the tile
    to 2^26 elements; elementwise metrics bound the (q, c, d) broadcast to
    2^24.  c_block is never below k (each step selects k candidates)."""
    qb = max(1, min(nq, 256))
    if metric in MXU_METRICS:
        cb = max(1024, (1 << 26) // qb)
    else:
        cb = max(128, (1 << 24) // max(qb * d, 1))
    cb = max(cb, k)
    return qb, min(cap, next_pow2(min(cb, cap)))


def _order_keys(scores: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (score desc, position asc).

    The float32 score maps to an order-preserving int32 (sign-magnitude
    bits flipped for negatives), shifted above the reversed position, so
    one ``torch.topk`` over the keys selects exactly — ties at the k-th
    place can no longer resolve arbitrarily.  Slots with a negative
    position (missing) rank last."""
    bits = (scores + 0.0).contiguous().view(torch.int32)  # -0.0 → +0.0
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    key = ordered.to(torch.int64) * _LOW + (_LOW - 1 - pos.to(torch.int64))
    return torch.where(pos < 0, _INT64_MIN, key)


def topk_ordered(scores: torch.Tensor, pos: torch.Tensor, k: int):
    """Best k of each row of (scores, positions), both (Q, N), sorted
    score descending then position ascending."""
    k = min(int(k), scores.shape[1])
    _, sel = torch.topk(_order_keys(scores, pos), k, dim=1)
    return scores.gather(1, sel), pos.gather(1, sel)


def exact_topk(scores: torch.Tensor, k: int):
    """(values, indices) of the k best of each row; equal scores resolve to
    the lower index."""
    idx = torch.arange(scores.shape[1], device=scores.device)
    return topk_ordered(scores, idx.expand_as(scores), k)


def search_scan(xb, nvalid, xq, k, metric, metric_arg=0.0, mask=None,
                tile=None, blocks=None):
    """Blocked scan over rows [0, nvalid) of a (cap, ...) corpus buffer;
    returns (scores (nq, k), positions (nq, k) int32).  Scores are
    max-oriented (negated distances for min metrics); missing slots are
    (-inf, -1).  ``tile(q0, q1, c0, c1)``, where given, returns the
    max-oriented (q1 - q0, c1 - c0) scores of queries [q0, q1) against
    buffer rows [c0, c1) in place of ``pairwise_tile`` over xb's fp32 rows
    (the SQ scans decode or dot codes there), and ``blocks`` the (q_block,
    c_block) in place of ``choose_blocks``'s."""
    cap = xb.shape[0]
    nq, d = xq.shape
    sim = metric in SIMILARITY_METRICS
    if tile is None:
        def tile(q0, q1, c0, c1):
            dist = pairwise_tile(xq[q0:q1], xb[c0:c1], metric, metric_arg)
            return dist if sim else -dist
    q_block, c_block = blocks or choose_blocks(cap, nq, d, metric, k)
    # Rows at or beyond nvalid hold no candidate: not scanned.
    n_scan = max(0, min(cap, int(nvalid)))
    dev = xq.device
    out_s = torch.full((nq, k), _NEG_INF, dtype=torch.float32, device=dev)
    out_p = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for q0 in range(0, nq, q_block):
        q1 = min(q0 + q_block, nq)
        best_s = out_s[q0:q1]
        best_p = out_p[q0:q1]
        for c0 in range(0, n_scan, c_block):
            c1 = min(c0 + c_block, n_scan)
            score = tile(q0, q1, c0, c1)
            if mask is not None:
                score = torch.where(mask[c0:c1].to(torch.bool)[None, :],
                                    score, _NEG_INF)
            rowid = torch.arange(c0, c1, dtype=torch.int32, device=dev)
            best_s, best_p = topk_ordered(
                torch.cat([best_s, score], 1),
                torch.cat([best_p, rowid.expand_as(score)], 1), k)
        out_s[q0:q1] = best_s
        out_p[q0:q1] = best_p
    # A -inf slot may hold an invalid row's position (fewer than k valid).
    return out_s, out_p.masked_fill(torch.isneginf(out_s), -1)


def finalize_scores(scores, positions, metric):
    """Convert max-oriented scores to the output distance convention with
    FAISS sentinels for missing slots."""
    sim = metric in SIMILARITY_METRICS
    missing = torch.isneginf(scores)
    dist = scores if sim else -scores
    sentinel = _NEG_INF if sim else float("inf")
    dist = torch.where(missing, sentinel, dist)
    positions = torch.where(missing, -1, positions)
    return dist, positions


def flat_search(xb_pad: torch.Tensor, nvalid: int, xq_pad: torch.Tensor,
                k: int, metric: str, metric_arg: float = 0.0,
                mask: torch.Tensor | None = None):
    """Search over a padded corpus.  Returns (distances (nq, k) fp32,
    positions (nq, k) int32; -1 where fewer than k candidates)."""
    cap = xb_pad.shape[0]
    if k > cap:
        raise ValueError(f"k={k} exceeds padded capacity {cap}; caller must clamp")
    return finalize_scores(*search_scan(xb_pad, nvalid, xq_pad, k, metric,
                                        metric_arg, mask), metric)
