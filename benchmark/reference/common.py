"""What the plain references share: precision control, a running top-k,
the exact float64 scoring of chosen (query, row) pairs, and the result.

Plain PyTorch only.  Scores are oriented "higher is better" throughout
(an L2 reference scores −‖q − x‖²).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

#: candidates kept beyond k by the fp32 selection, rescored in float64
WIDE = 32
#: queries a score block takes
QUERY_BLOCK = 1024
#: (query, row) pairs a float64 scoring block takes
PAIR_BLOCK = 1 << 16


@contextlib.contextmanager
def fp32_exact():
    """float32 matmuls without TF32 inside, whatever the caller set."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero, as the tensor cores' input conversion): a product of
    two such values is exact in fp32, so an fp32 matmul of rounded operands
    is a TF32 matmul, on the card and on the CPU alike."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class TopK:
    """The best ``width`` (score, row) of each of ``nq`` queries, merged
    block by block."""

    def __init__(self, nq: int, width: int, device):
        self.width = width
        self.score = torch.full((nq, width), float("-inf"), device=device)
        self.row = torch.full((nq, width), -1, dtype=torch.int64,
                              device=device)

    def push(self, q0: int, scores: torch.Tensor, row0: int) -> None:
        """Merge ``scores`` (qb, m) of rows row0 … row0 + m − 1 into the
        queries q0 … q0 + qb − 1."""
        q1 = q0 + scores.shape[0]
        w = min(self.width, scores.shape[1])
        s, r = torch.topk(scores, w, dim=1)
        s = torch.cat([self.score[q0:q1], s], 1)
        r = torch.cat([self.row[q0:q1], r + row0], 1)
        best, at = torch.topk(s, self.width, dim=1)
        self.score[q0:q1] = best
        self.row[q0:q1] = torch.where(torch.isneginf(best), -1,
                                      r.gather(1, at))


def exact_pairs(data, pair_q: torch.Tensor, pair_row: torch.Tensor,
                score64) -> torch.Tensor:
    """float64 scores of (query, row) pairs (rows −1: NaN), each chunk of
    the corpus drawn again once: ``score64(q_index, rows64 (m, d))``
    scores m pairs."""
    out = torch.full(pair_q.shape, float("nan"), dtype=torch.float64,
                     device=pair_q.device)
    base = 0
    for i, n in data.chunk_sizes():
        sel = torch.nonzero((pair_row >= base) & (pair_row < base + n))[:, 0]
        if sel.numel():
            x = data.chunk(i)
            for b0 in range(0, sel.numel(), PAIR_BLOCK):
                s = sel[b0:b0 + PAIR_BLOCK]
                out[s] = score64(pair_q[s],
                                 x[pair_row[s] - base].to(torch.float64))
        base += n
    return out


def rescore_top(pool_row: torch.Tensor, pool_score64: torch.Tensor, k: int):
    """The best k float64 scores of each query's pool (nq, k), −inf where
    the pool holds fewer than k rows."""
    s = torch.where(pool_row >= 0, pool_score64,
                    torch.full_like(pool_score64, float("-inf")))
    return torch.topk(s, k, dim=1).values


@dataclasses.dataclass
class Solution:
    """What a reference worked out for the pool's queries (P of them).

    ``lo`` / ``hi`` (P, k) float64: rank-wise bounds on the exact scores
    of a correct answer (equal where the answer is unique); ``scale`` (P,)
    the magnitude the gaps are measured against; ``want_score`` /
    ``want_allowed``: the exact score of each asked (query, label) pair
    (NaN for a label no row has) and whether its row may answer the query;
    ``truth`` (P, k) the exact labels over every row (for recall, or
    None); ``control``: the control's (labels, distances) (P, k) and their
    exact scores and admissibility, when asked for; ``detail``: per query
    data for the work count; ``checks``: the reference's own numbers
    (name → (value, limit))."""
    lo: np.ndarray
    hi: np.ndarray
    scale: np.ndarray
    want_score: np.ndarray
    want_allowed: np.ndarray
    truth: np.ndarray | None = None
    control: dict | None = None
    detail: dict | None = None
    checks: dict = dataclasses.field(default_factory=dict)


def scale_of(hi: torch.Tensor) -> torch.Tensor:
    """A query's score magnitude: the larger of |best| and |k-th best|."""
    h = torch.where(torch.isfinite(hi), hi.abs(), torch.zeros_like(hi))
    return torch.maximum(h[:, 0], h[:, -1]).clamp(min=1e-30)


class LabelMap:
    """The generator's labels of the rows (their positions where it gives
    none), both ways."""

    def __init__(self, data):
        ids = data.ids()
        self.ids = (np.arange(data.rows, dtype=np.int64) if ids is None
                    else ids)
        self.order = np.argsort(self.ids, kind="stable")
        self.sorted = self.ids[self.order]

    def rows_of(self, labels: np.ndarray) -> np.ndarray:
        """The row of each label, −1 for a label no row has."""
        at = np.clip(np.searchsorted(self.sorted, labels), 0,
                     len(self.ids) - 1)
        return np.where(self.sorted[at] == labels, self.order[at], -1)

    def labels_of(self, rows: np.ndarray) -> np.ndarray:
        """The label of each row, −1 for row −1."""
        return np.where(rows >= 0, self.ids[np.clip(rows, 0, None)], -1)


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
