"""The plain reference of HNSW search (``IDMap,HNSWm,Flat``, inner product
or L2).

A graph walk is approximate: FAISS's IndexHNSW returns k rows of the
corpus with their exact fp32 scores, best first, and finds most of the
exact top k (its recall, set by efSearch).  The reference works the exact
answer out again from the seed and judges every answer of the window:

* ``dist_err``: each returned distance against the exact (float64) score
  of the row its label names; ``rank_gap``: the exact score of the row
  returned at rank j above the exact j-th best (``hi``; ``lo`` is −inf,
  since an approximate answer may miss a row but never beat the best);
* ``bad_answers`` (``compare.py``): a rank column other than 0 … k−1, a
  label no row has, a label twice, a distance that is not finite;
* ``recall_miss``: 1 − the mean over the window's queries of the share of
  the exact top k (over every row) among the labels returned for it;
* ``unreachable``: the share of rows that no row of the built adjacency
  (``state["graph"]``, the port's read-only ``HNSWIndex.graph``) names, so
  that a walk reaches them only as a seed.

As detail it reports ``edge_recall``: over ``EDGE_ROWS`` rows drawn from
the run's seed, the share of each one's exact ``EDGE_K`` nearest other
rows that its adjacency row holds.  The corpus is drawn again chunk by
chunk after the index is freed, scored in fp32 with TF32 off, and the best
k + WIDE rows of each query are rescored in float64.  The control is the
exact search with its products in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (QUERY_BLOCK, WIDE, LabelMap, Solution, TopK,
                     exact_pairs, fp32_exact, host, scale_of, to_tf32)
from .flat import scores as row_scores

#: rows whose adjacency the edge recall reads, and their neighbours held
EDGE_ROWS, EDGE_K = 4096, 10
#: adjacency rows a block of the reachability count moves to the device
GRAPH_BLOCK = 1 << 20


def sample_rows(data, rows: np.ndarray) -> torch.Tensor:
    """Rows ``rows`` (sorted) of the corpus, drawn again chunk by chunk."""
    out, base = [], 0
    for i, n in data.chunk_sizes():
        sel = rows[(rows >= base) & (rows < base + n)] - base
        if sel.size:
            out.append(data.chunk(i)[torch.from_numpy(sel).to(data.device)])
        base += n
    return torch.cat(out)


def unreachable_share(adj: np.ndarray, dev) -> float:
    """The share of an (n, deg) adjacency's rows that no row names."""
    n = adj.shape[0]
    named = torch.zeros(n, dtype=torch.bool, device=dev)
    for r0 in range(0, n, GRAPH_BLOCK):
        e = torch.from_numpy(np.array(adj[r0:r0 + GRAPH_BLOCK])).to(
            dev).reshape(-1)
        named[e[e >= 0].long()] = True
    return float((~named).sum()) / max(n, 1)


def edge_recall(adj: np.ndarray, rows: np.ndarray, near: np.ndarray) -> float:
    """Mean share of each row's exact neighbours ``near`` (m, EDGE_K) that
    its adjacency row holds."""
    return float(np.mean([np.isin(nb, adj[r]).mean()
                          for r, nb in zip(rows, near)]))


def recall_of_pairs(want_q: np.ndarray, want_rows: np.ndarray,
                    truth_rows: np.ndarray, k: int) -> float:
    """Mean over the queries in ``want_q`` of the share of their exact top
    k (``truth_rows`` (P, k)) among the distinct rows returned for them."""
    if want_q.size == 0:
        return 0.0
    hit = (truth_rows[want_q] == want_rows[:, None]).any(1)
    queries = np.unique(want_q)
    got = np.bincount(want_q, weights=hit, minlength=truth_rows.shape[0])
    return float(np.mean(np.minimum(got[queries], k) / k))


def solve(cfg: dict, data, queries: np.ndarray, state: dict,
          want_q: np.ndarray, want_label: np.ndarray,
          control: bool = False) -> Solution:
    dev = data.device
    k, l2 = int(cfg["k"]), cfg["metric"] == "L2"
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    qn = (q * q).sum(1)
    nq = q.shape[0]
    width = k + WIDE
    rng = np.random.default_rng(data.seed)
    edge = np.sort(rng.choice(data.rows, min(EDGE_ROWS, data.rows - 1),
                              replace=False))
    xe = sample_rows(data, edge)
    xen = (xe * xe).sum(1)
    edge_dev = torch.from_numpy(edge).to(dev)
    pool = TopK(nq, width, dev)
    near = TopK(edge.size, EDGE_K, dev)
    ctl = TopK(nq, k, dev) if control else None
    neg = torch.tensor(float("-inf"), device=dev)
    base = 0
    with fp32_exact():
        for i, n in data.chunk_sizes():
            x = data.chunk(i)
            xn = (x * x).sum(1)
            xt = to_tf32(x) if control else None
            for q0 in range(0, nq, QUERY_BLOCK):
                qb, qnb = q[q0:q0 + QUERY_BLOCK], qn[q0:q0 + QUERY_BLOCK]
                pool.push(q0, row_scores(qb, qnb, x, xn, l2), base)
                if control:
                    ctl.push(q0, row_scores(to_tf32(qb), qnb, xt, xn, l2),
                             base)
            cols = torch.arange(base, base + n, device=dev)
            for e0 in range(0, edge.size, QUERY_BLOCK):
                eb = edge_dev[e0:e0 + QUERY_BLOCK]
                s = row_scores(xe[e0:e0 + QUERY_BLOCK],
                               xen[e0:e0 + QUERY_BLOCK], x, xn, l2)
                near.push(e0, torch.where(eb[:, None] == cols[None, :], neg,
                                          s), base)
            base += n

    labels = LabelMap(data)

    def score64(qi, x64):
        q64 = q[qi].to(torch.float64)
        return (-((q64 - x64) ** 2).sum(1) if l2 else (q64 * x64).sum(1))

    want_rows = labels.rows_of(np.asarray(want_label, np.int64))
    pair_q = [torch.arange(nq, device=dev).repeat_interleave(width),
              torch.from_numpy(np.asarray(want_q, np.int64)).to(dev)]
    pair_row = [pool.row.reshape(-1), torch.from_numpy(want_rows).to(dev)]
    if control:
        pair_q.append(torch.arange(nq, device=dev).repeat_interleave(k))
        pair_row.append(ctl.row.reshape(-1))
    s64 = exact_pairs(data, torch.cat(pair_q), torch.cat(pair_row), score64)
    m0, m1 = nq * width, nq * width + len(want_rows)
    p64 = torch.where(pool.row >= 0, s64[:m0].reshape(nq, width),
                      torch.full((nq, width), float("-inf"),
                                 dtype=torch.float64, device=dev))
    best, at = torch.topk(p64, k, dim=1)
    truth_rows = host(torch.where(torch.isneginf(best), -1,
                                  pool.row.gather(1, at)))

    recall = recall_of_pairs(np.asarray(want_q, np.int64), want_rows,
                             truth_rows, k)
    adj = state.get("graph")
    unreachable = 1.0 if adj is None else unreachable_share(adj, dev)
    edges = (0.0 if adj is None else
             edge_recall(adj, edge, host(near.row)))
    lims = cfg["limits"]
    sol = Solution(
        lo=np.full((nq, k), -np.inf), hi=host(best),
        scale=host(scale_of(best)), want_score=host(s64[m0:m1]),
        want_allowed=want_rows >= 0, truth=labels.labels_of(truth_rows),
        detail={"recall": recall, "unreachable": unreachable,
                "edge_recall": edges},
        checks={"recall_miss": (1.0 - recall, float(lims["recall_miss"])),
                "unreachable": (unreachable, float(lims["unreachable"]))})
    if control:
        crow = host(ctl.row)
        sign = -1.0 if l2 else 1.0
        sol.control = {
            "labels": labels.labels_of(crow),
            "distances": sign * host(ctl.score),
            "exact": host(s64[m1:]).reshape(nq, k),
            "allowed": crow >= 0}
    return sol
