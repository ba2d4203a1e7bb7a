"""The plain reference of exact Flat search (L2 or inner product).

Every row of the corpus, drawn again from the seed, is scored against the
pool's queries in fp32 with TF32 off; the best k + WIDE rows of each query
are rescored in float64, and their best k are the exact answer (``lo`` =
``hi``).  Labels are the generator's.  The control is the same search with
its products in TF32: its top k and its TF32 distances.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (QUERY_BLOCK, WIDE, LabelMap, Solution, TopK,
                     exact_pairs, fp32_exact, host, rescore_top, scale_of,
                     to_tf32)


def scores(qb, qn, x, xn, l2: bool):
    """fp32 higher-is-better scores (qb, m): −‖q − x‖² or q·x."""
    dots = qb @ x.T
    return 2.0 * dots - xn[None, :] - qn[:, None] if l2 else dots


def solve(cfg: dict, data, queries: np.ndarray, state: dict,
          want_q: np.ndarray, want_label: np.ndarray,
          control: bool = False) -> Solution:
    dev = data.device
    k, l2 = int(cfg["k"]), cfg["metric"] == "L2"
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    qn = (q * q).sum(1)
    nq = q.shape[0]
    pool = TopK(nq, k + WIDE, dev)
    ctl = TopK(nq, k, dev) if control else None
    base = 0
    with fp32_exact():
        for i, n in data.chunk_sizes():
            x = data.chunk(i)
            xn = (x * x).sum(1)
            xt = to_tf32(x) if control else None
            for q0 in range(0, nq, QUERY_BLOCK):
                qb, qnb = q[q0:q0 + QUERY_BLOCK], qn[q0:q0 + QUERY_BLOCK]
                pool.push(q0, scores(qb, qnb, x, xn, l2), base)
                if control:
                    ctl.push(q0, scores(to_tf32(qb), qnb, xt, xn, l2), base)
            base += n

    labels = LabelMap(data)

    def score64(qi, x64):
        q64 = q[qi].to(torch.float64)
        return (-((q64 - x64) ** 2).sum(1) if l2 else (q64 * x64).sum(1))

    width = k + WIDE
    pair_q = [torch.arange(nq, device=dev).repeat_interleave(width)]
    pair_row = [pool.row.reshape(-1)]
    want_rows = labels.rows_of(np.asarray(want_label, np.int64))
    pair_q.append(torch.from_numpy(np.asarray(want_q, np.int64)).to(dev))
    pair_row.append(torch.from_numpy(want_rows).to(dev))
    if control:
        pair_q.append(torch.arange(nq, device=dev).repeat_interleave(k))
        pair_row.append(ctl.row.reshape(-1))
    s64 = exact_pairs(data, torch.cat(pair_q), torch.cat(pair_row), score64)
    m0, m1 = nq * width, nq * width + len(want_rows)
    best = rescore_top(pool.row, s64[:m0].reshape(nq, width), k)
    sol = Solution(lo=host(best), hi=host(best), scale=host(scale_of(best)),
                   want_score=host(s64[m0:m1]),
                   want_allowed=want_rows >= 0)
    if control:
        crow = host(ctl.row)
        sign = -1.0 if l2 else 1.0
        sol.control = {
            "labels": labels.labels_of(crow),
            "distances": sign * host(ctl.score),
            "exact": host(s64[m1:]).reshape(nq, k),
            "allowed": crow >= 0}
    return sol
