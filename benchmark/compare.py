"""The comparison that decides ``correct``.

Every answer a call returned is held against what the reference worked
out for its query (``reference/common.py::Solution``).  Three numbers, each
with its limit from the configuration file:

* ``dist_err``: the largest gap between a returned distance and the exact
  (float64) score of the row it names, over the query's score magnitude;
* ``rank_gap``: the largest amount by which the exact score of the row
  returned at rank j lies outside the reference's rank-j bounds [lo, hi],
  over the same magnitude (an exact search has lo = hi);
* ``bad_answers``: answers that are malformed: a rank column other than
  0 … k−1, a label no row has, a row the query may not reach (an IVF row
  outside the lists it can probe), a label twice, a distance that is not
  finite.  Limit 0.

An answer fails when it is malformed or one of its gaps passes its limit.
"""

from __future__ import annotations

import numpy as np

#: the numbers the comparison reports, in the order printed
NUMBERS = ("dist_err", "rank_gap", "bad_answers")


def want_pairs(qi: np.ndarray, labels: np.ndarray):
    """The distinct (query, label) pairs of answers (M,) × (M, k): (pair
    queries, pair labels, each entry's pair index (M, k))."""
    flat = labels.reshape(-1)
    uniq, lab_inv = np.unique(flat, return_inverse=True)
    key = np.repeat(qi.astype(np.int64), labels.shape[1]) * len(uniq) + \
        lab_inv.reshape(-1)
    ukey, inv = np.unique(key, return_inverse=True)
    return (ukey // len(uniq), uniq[ukey % len(uniq)],
            inv.reshape(labels.shape))


def readings(qi, ranks, labels, dists, exact, allowed, sol, similarity):
    """Per answer (M,): (malformed, dist_err, rank_gap)."""
    k = labels.shape[1]
    scale = sol.scale[qi][:, None]
    score = dists.astype(np.float64) * (1.0 if similarity else -1.0)
    srt = np.sort(labels, 1)
    bad = ((ranks != np.arange(k)[None, :]).any(1) | ~allowed.all(1)
           | (srt[:, 1:] == srt[:, :-1]).any(1)
           | ~np.isfinite(dists).all(1) | ~np.isfinite(exact).all(1))
    with np.errstate(invalid="ignore"):
        err = np.nan_to_num(np.abs(score - exact) / scale, nan=0.0).max(1)
        over = np.maximum(sol.lo[qi] - exact, exact - sol.hi[qi])
        gap = np.nan_to_num(np.maximum(over, 0.0) / scale, nan=0.0).max(1)
    return bad, err, gap


def judge(bad, err, gap, limits) -> tuple[dict, np.ndarray]:
    """The numbers over all answers, and which answers failed."""
    numbers = {"dist_err": float(err.max(initial=0.0)),
               "rank_gap": float(gap.max(initial=0.0)),
               "bad_answers": int(bad.sum())}
    failed = (bad | (err > limits["dist_err"])
              | (gap > limits["rank_gap"]))
    return numbers, failed


def compare_answers(qi, ranks, labels, dists, sol, inv, similarity, limits):
    """Judge answers whose (query, label) pairs the reference scored
    (``inv``: each entry's pair index into ``sol.want_*``)."""
    exact = sol.want_score[inv]
    allowed = sol.want_allowed[inv]
    return judge(*readings(qi, ranks, labels, dists, exact, allowed, sol,
                           similarity), limits)


def compare_control(sol, similarity, limits):
    """Judge the control's answers (one a pool query) the same way."""
    c = sol.control
    nq, k = c["labels"].shape
    qi = np.arange(nq)
    ranks = np.broadcast_to(np.arange(k, dtype=np.int32), (nq, k))
    return judge(*readings(qi, ranks, c["labels"], c["distances"],
                           c["exact"], c["allowed"], sol, similarity), limits)
