"""The plain reference of filtered IVF,Flat search (L2 or inner product).

The answer ``faiss_search_filter`` owes a query over an ``IVFn,Flat``
index (FAISS IndexIVFFlat with an IDSelectorBitmap) is the exact top k, by
the fp32 score of each row, among the rows that pass the filter in the
nprobe lists whose centroids score best against the query, each row held
in the list of the centroid that scores best against it.  The reference
works it out again from the data, with ``reference/ivf_flat.py``'s
helpers:

* The centroid table is the one thing it takes from the index, checked by
  ``kmeans_gain``: one Lloyd step from it over the rows k-means was
  trained on (the corpus's first ``train_rows``) may improve their mean
  best score by a share of at most the limit.
* Each row's possible lists (float64 scores, either list within the fp32
  rounding bound γ_{d+2} of the best), and the lists a query surely / may
  probe, as ``ivf_flat.py`` bounds them.
* The filter is evaluated here from the generator's side table (``sel <
  below`` over ``ids(i, sel)``), mapped to rows through the labels:
  nothing of the port's SQL engine or bitmap is read.
* A row may answer a query when it passes the filter and one of its
  possible lists may be probed; it surely counts when every one surely is.
  The best k + POOL of the rows that may answer (fp32, TF32 off) are
  rescored in float64: ``hi`` is their best k, ``lo`` the best k of the
  sure ones.  A returned row that fails the filter is not allowed, and so
  a bad answer.

The corpus is drawn again from the seed chunk by chunk after the index is
freed, so no second copy is held.  No ``truth`` (the cell reports no
recall: the answers are exact within the probed lists).  The control is
the same search with its products in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (QUERY_BLOCK, LabelMap, Solution, TopK, exact_pairs,
                     fp32_exact, host, rescore_top, scale_of, to_tf32)
from .flat import scores as row_scores
from .ivf_flat import (ASSIGN_WIDTH, POOL, ROW_BLOCK, coarse, coarse_tf32,
                       kmeans_gain, possible_lists, probe_sets)


class Prefix:
    """The generator's first ``rows`` rows, chunk by chunk (the rows the
    coarse k-means was trained on)."""

    def __init__(self, data, rows: int):
        self.data, self.device = data, data.device
        self.sizes, left = [], int(rows)
        for i, n in data.chunk_sizes():
            if left <= 0:
                break
            self.sizes.append((i, min(n, left)))
            left -= n
        self.rows = sum(n for _, n in self.sizes)

    def chunk_sizes(self):
        return self.sizes

    def chunk(self, i: int) -> torch.Tensor:
        return self.data.chunk(i)[:dict(self.sizes)[i]]


def training_rows(cfg: dict, data) -> Prefix:
    return Prefix(data, min(int(cfg["train_rows"]), data.rows))


def passing_rows(cfg: dict, data) -> np.ndarray:
    """(rows,) bool: the rows whose label the filter passes (``column <
    below`` in the side table, looked up by ``idselector``)."""
    f = cfg["filter"]
    table = data.table()
    ok = np.asarray(table[f["column"]]) < f["below"]
    rows = LabelMap(data).rows_of(np.asarray(table[f["idselector"]],
                                             np.int64))
    out = np.zeros(data.rows, bool)
    out[rows[rows >= 0]] = ok[rows >= 0]
    return out


def untrained_gain(cfg: dict, data, seed: int) -> float:
    """``kmeans_gain`` of a table that training left as it started: nlist
    distinct training rows drawn from ``seed`` (a fault, for the limit)."""
    train = training_rows(cfg, data)
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    pick = torch.randperm(train.rows, generator=g)[:int(cfg["nlist"])]
    pick = pick.sort().values
    rows, base = [], 0
    for i, n in train.chunk_sizes():
        sel = pick[(pick >= base) & (pick < base + n)] - base
        if sel.numel():
            rows.append(train.chunk(i)[sel.to(data.device)])
        base += n
    return kmeans_gain(train, torch.cat(rows), cfg["metric"] == "L2")


def solve(cfg: dict, data, queries: np.ndarray, state: dict,
          want_q: np.ndarray, want_label: np.ndarray,
          control: bool = False) -> Solution:
    if cfg["precision"] != "parity":
        raise ValueError("the IVF,Flat reference bounds fp32 scores only")
    dev = data.device
    k, nlist = int(cfg["k"]), int(cfg["nlist"])
    nprobe, l2 = int(cfg["nprobe"]), cfg["metric"] == "L2"
    cent = torch.from_numpy(np.asarray(state["centroids"], np.float32)).to(
        dev)
    passing = torch.from_numpy(passing_rows(cfg, data)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    qn = (q * q).sum(1)
    nq = q.shape[0]
    qs, qtol = coarse(q, cent, l2)
    sure_p, may_p = probe_sets(qs, qtol, nprobe)
    exact_probes = torch.topk(qs, nprobe, dim=1).indices
    if control:
        ctl_p = torch.zeros_like(sure_p).scatter_(
            1, torch.topk(coarse_tf32(q, cent, l2), nprobe, dim=1).indices,
            True)

    width = k + POOL
    pool = TopK(nq, width, dev)
    ctl = TopK(nq, k, dev) if control else None
    cand = torch.empty((data.rows, ASSIGN_WIDTH), dtype=torch.int64,
                       device=dev)
    poss = torch.empty((data.rows, ASSIGN_WIDTH), dtype=torch.bool,
                       device=dev)
    ties = 0
    neg = torch.tensor(float("-inf"), device=dev)
    base = 0
    with fp32_exact():
        for i, n in data.chunk_sizes():
            x = data.chunk(i)
            xn = (x * x).sum(1)
            ok_rows = passing[base:base + n]
            ctl_a = (torch.empty(n, dtype=torch.int64, device=dev)
                     if control else None)
            for r0 in range(0, n, ROW_BLOCK):
                xb = x[r0:r0 + ROW_BLOCK]
                s, tol = coarse(xb, cent, l2)
                c, ok, t = possible_lists(s, tol)
                cand[base + r0:base + r0 + xb.shape[0]] = c
                poss[base + r0:base + r0 + xb.shape[0]] = ok
                ties += t
                if control:
                    ctl_a[r0:r0 + xb.shape[0]] = coarse_tf32(
                        xb, cent, l2).argmax(1)
            c, ok = cand[base:base + n], poss[base:base + n]
            xt = to_tf32(x) if control else None
            for q0 in range(0, nq, QUERY_BLOCK):
                qb, qnb = q[q0:q0 + QUERY_BLOCK], qn[q0:q0 + QUERY_BLOCK]
                mp = may_p[q0:q0 + QUERY_BLOCK]
                may = torch.zeros((qb.shape[0], n), dtype=torch.bool,
                                  device=dev)
                for t in range(ASSIGN_WIDTH):
                    may |= ok[:, t][None, :] & mp[:, c[:, t]]
                may &= ok_rows[None, :]
                sc = row_scores(qb, qnb, x, xn, l2)
                pool.push(q0, torch.where(may, sc, neg), base)
                if control:
                    reach = (ctl_p[q0:q0 + QUERY_BLOCK][:, ctl_a]
                             & ok_rows[None, :])
                    ctl.push(q0, torch.where(
                        reach, row_scores(to_tf32(qb), qnb, xt, xn, l2),
                        neg), base)
            base += n

    gain = kmeans_gain(training_rows(cfg, data), cent, l2)
    labels = LabelMap(data)

    def score64(qi, x64):
        q64 = q[qi].to(torch.float64)
        return (-((q64 - x64) ** 2).sum(1) if l2 else (q64 * x64).sum(1))

    want_rows = labels.rows_of(np.asarray(want_label, np.int64))
    pair_q = [torch.arange(nq, device=dev).repeat_interleave(width)]
    pair_row = [pool.row.reshape(-1)]
    wq = torch.from_numpy(np.asarray(want_q, np.int64)).to(dev)
    wr = torch.from_numpy(want_rows).to(dev)
    pair_q.append(wq)
    pair_row.append(wr)
    if control:
        pair_q.append(torch.arange(nq, device=dev).repeat_interleave(k))
        pair_row.append(ctl.row.reshape(-1))
    s64 = exact_pairs(data, torch.cat(pair_q), torch.cat(pair_row), score64)
    m = nq * width
    p64 = s64[:m].reshape(nq, width)
    hi = rescore_top(pool.row, p64, k)

    def reach(qi, rows, probes):
        """Per (query, row) pair: (the row passes and any of its possible
        lists is in ``probes``, every one is); rows −1: False / False."""
        r = rows.clamp(min=0)
        hit = probes[qi[:, None], cand[r]]
        ok = poss[r] & (rows >= 0)[:, None]
        live = passing[r] & (rows >= 0)
        return ((hit & ok).any(1) & live, (hit | ~ok).all(1) & live)

    flat_q = torch.arange(nq, device=dev).repeat_interleave(width)
    in_sure = reach(flat_q, pool.row.reshape(-1), sure_p)[1].reshape(
        nq, width)
    lo = rescore_top(torch.where(in_sure, pool.row, -1), p64, k)
    w1 = m + len(want_rows)

    first = cand[:, 0]
    sol = Solution(
        lo=host(lo), hi=host(hi), scale=host(scale_of(hi)),
        want_score=host(s64[m:w1]),
        want_allowed=host(reach(wq, wr, may_p)[0]),
        truth=None,
        detail={"probes": host(exact_probes),
                "list_rows": host(torch.bincount(first, minlength=nlist)),
                "list_pass": host(torch.bincount(first[passing],
                                                 minlength=nlist)),
                "ambiguous": int((may_p.sum(1) > nprobe).sum()),
                "assign_unsure": int((poss[:, 1:].any(1)).sum()),
                "assign_ties": ties,
                "passing": int(passing.sum()),
                "kmeans_gain": gain},
        checks={"kmeans_gain": (gain, float(cfg["limits"]["kmeans_gain"]))})
    if control:
        crow = host(ctl.row)
        sign = -1.0 if l2 else 1.0
        cq = torch.arange(nq, device=dev).repeat_interleave(k)
        sol.control = {
            "labels": labels.labels_of(crow),
            "distances": sign * host(ctl.score),
            "exact": host(s64[w1:]).reshape(nq, k),
            "allowed": host(reach(cq, ctl.row.reshape(-1), may_p)[0]
                            ).reshape(nq, k)}
    return sol
