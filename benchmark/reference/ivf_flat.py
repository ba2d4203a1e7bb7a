"""The plain reference of IVF,Flat search (L2 or inner product).

The answer an ``IVFn,Flat`` index owes a query (FAISS IndexIVFFlat) is the
exact top k, by the fp32 score of each row, over the rows of the nprobe
lists whose centroids score best against the query, each row held in the
list of the centroid that scores best against it.  The reference works it
out again from the data:

* The centroid table is the one thing it takes from the index (k-means
  cannot be redone bit for bit), and it checks the table by itself: one
  Lloyd step from it over every row (the training rows: nlist · 256 rows
  is at least the corpus, so FAISS's subsample keeps them all) may improve
  the mean best score by a share of at most ``kmeans_gain``'s limit.
  Trained centroids sit near such a fixed point; a table that training
  left unconverged, such as its random start, does not.
* Each row's list is its best centroid by float64 scores.  The index
  scores in fp32, so where another centroid lies within the rounding bound
  of those scores, the row may be in either: both lists are possible for
  it, neither sure.  Nothing of the index's own assignment is read.
* The lists a query probes: its float64 centroid scores, each within the
  same rounding bound, give the lists that are surely among the nprobe
  best and those that may be.
* A row may answer a query when one of its possible lists may be probed,
  and surely counts when every one of them surely is.  The best k + POOL
  rows by fp32 scores (TF32 off) of those that may answer are rescored in
  float64: ``hi`` is their best k, ``lo`` the best k of the sure ones (a
  pool short of k sure rows leaves the lower ranks unbounded).  Any
  correct answer lies between them rank by rank, and every row of it may
  answer.  ``truth`` is the exact top k over every row, for recall.

The rounding bound of an fp32 score of d products, taken as the index
takes it (a matmul, and for L2 the expansion ‖q‖² − 2q·c + ‖c‖²), is
γ_{d+2} = (d + 2)·2^-24 of the sum of the magnitudes of its terms; it holds
for any order of summation.  The configuration's precision mode has to be
``parity`` (fp32 scores throughout).

The control is the same search with its products in TF32 (the rows' lists,
the probes and the row scores alike): its top k and their TF32 scores.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (QUERY_BLOCK, LabelMap, Solution, TopK, exact_pairs,
                     fp32_exact, host, rescore_top, scale_of, to_tf32)
from .flat import scores as row_scores

#: candidates kept beyond k from the rows that may answer
POOL = 64
#: possible lists kept a row (rows with more within the rounding bound of
#: the best are counted in ``detail["assign_ties"]``)
ASSIGN_WIDTH = 3
#: rows a block of the assignment takes (float64 (rows, nlist) tiles)
ROW_BLOCK = 1 << 15


def coarse(a: torch.Tensor, cent: torch.Tensor, l2: bool):
    """float64 higher-is-better scores (m, nlist) of rows ``a`` against the
    centroids (−‖a − c‖² or a·c), and the rounding bound of the fp32 scores
    the index takes of them."""
    a64, c64 = a.to(torch.float64), cent.to(torch.float64)
    dots = a64 @ c64.T
    with fp32_exact():
        mag = (a.abs() @ cent.abs().T).to(torch.float64)
    if l2:
        an, cn = (a64 * a64).sum(1), (c64 * c64).sum(1)
        s = 2.0 * dots - an[:, None] - cn[None, :]
        mag = an[:, None] + 2.0 * mag + cn[None, :]
    else:
        s = dots
    return s, mag * ((a.shape[1] + 2) * 2.0 ** -24 * 1.01)


def coarse_tf32(a: torch.Tensor, cent: torch.Tensor, l2: bool):
    """The control's fp32 scores with TF32 products."""
    dots = to_tf32(a) @ to_tf32(cent).T
    if not l2:
        return dots
    return 2.0 * dots - (a * a).sum(1)[:, None] - (cent * cent).sum(1)[None]


def probe_sets(s: torch.Tensor, tol: torch.Tensor, nprobe: int):
    """(sure, may) (nq, nlist) bool: the lists that surely are / may be
    among the nprobe best of each query, its scores ``s`` each within
    ``tol`` of what the index takes."""
    up, low = s + tol, s - tol
    nlist = s.shape[1]
    # lists other than l that could score above l / surely score above l
    could = nlist - torch.searchsorted(up.sort(1).values, low) - 1
    surely = nlist - torch.searchsorted(low.sort(1).values, up, right=True)
    return could <= nprobe - 1, surely <= nprobe - 1


def possible_lists(s: torch.Tensor, tol: torch.Tensor):
    """Each row's candidate lists (m, ASSIGN_WIDTH), best first, which of
    them may hold it, and the rows with more possible lists than kept."""
    low_best = (s - tol).amax(1, keepdim=True)
    up = s + tol
    width = min(ASSIGN_WIDTH + 1, s.shape[1])
    top, cand = torch.topk(up, width, dim=1)
    ok = top >= low_best
    ties = int(ok[:, ASSIGN_WIDTH:].any(1).sum()) if width > ASSIGN_WIDTH \
        else 0
    return cand[:, :ASSIGN_WIDTH], ok[:, :ASSIGN_WIDTH], ties


def _best_sum(data, cent: torch.Tensor, l2: bool, sums=None, counts=None):
    """The sum over every row of its best float64 score against the
    table; with ``sums`` / ``counts``, each row is also added to its best
    list's."""
    total = 0.0
    with fp32_exact():
        for i, n in data.chunk_sizes():
            x = data.chunk(i)
            for r0 in range(0, n, ROW_BLOCK):
                xb = x[r0:r0 + ROW_BLOCK]
                best = coarse(xb, cent, l2)[0].max(1)
                total += float(best.values.sum())
                if sums is not None:
                    sums.index_add_(0, best.indices, xb.to(torch.float64))
                    counts += torch.bincount(best.indices,
                                             minlength=cent.shape[0])
    return total


def kmeans_gain(data, cent: torch.Tensor, l2: bool) -> float:
    """The share by which one Lloyd step from the table (each list's mean,
    renormalised for inner product, as FAISS trains it; an empty list
    keeps its centroid) improves the mean best score over every row."""
    sums = torch.zeros(cent.shape, dtype=torch.float64, device=cent.device)
    counts = torch.zeros(cent.shape[0], dtype=torch.float64,
                         device=cent.device)
    before = _best_sum(data, cent, l2, sums, counts)
    moved = sums / counts.clamp(min=1.0)[:, None]
    if not l2:
        moved = moved / moved.norm(dim=1, keepdim=True).clamp(min=1e-20)
    moved = torch.where((counts > 0)[:, None], moved.to(torch.float32), cent)
    return (_best_sum(data, moved, l2) - before) / max(abs(before), 1e-30)


def untrained_gain(cfg: dict, data, seed: int) -> float:
    """``kmeans_gain`` of a table that training left as it started: nlist
    distinct rows drawn from ``seed`` (a fault, for the limit)."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    pick = torch.randperm(data.rows, generator=g)[:int(cfg["nlist"])]
    pick = pick.sort().values
    rows, base = [], 0
    for i, n in data.chunk_sizes():
        sel = pick[(pick >= base) & (pick < base + n)] - base
        if sel.numel():
            rows.append(data.chunk(i)[sel.to(data.device)])
        base += n
    return kmeans_gain(data, torch.cat(rows), cfg["metric"] == "L2")


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
    truth = TopK(nq, k, dev)
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
                sc = row_scores(qb, qnb, x, xn, l2)
                truth.push(q0, sc, base)
                pool.push(q0, torch.where(may, sc, neg), base)
                if control:
                    ctl.push(q0, torch.where(
                        ctl_p[q0:q0 + QUERY_BLOCK][:, ctl_a],
                        row_scores(to_tf32(qb), qnb, xt, xn, l2), neg), base)
            base += n

    gain = kmeans_gain(data, cent, l2)
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
        """Per (query, row) pair: any / every possible list of the row in
        ``probes`` (rows −1: False / False)."""
        r = rows.clamp(min=0)
        hit = probes[qi[:, None], cand[r]]
        ok = poss[r] & (rows >= 0)[:, None]
        return ((hit & ok).any(1), ((hit | ~ok).all(1) & (rows >= 0)))

    flat_q = torch.arange(nq, device=dev).repeat_interleave(width)
    in_sure = reach(flat_q, pool.row.reshape(-1), sure_p)[1].reshape(
        nq, width)
    lo = rescore_top(torch.where(in_sure, pool.row, -1), p64, k)
    w1 = m + len(want_rows)

    sol = Solution(
        lo=host(lo), hi=host(hi), scale=host(scale_of(hi)),
        want_score=host(s64[m:w1]),
        want_allowed=host(reach(wq, wr, may_p)[0]),
        truth=labels.labels_of(host(truth.row)),
        detail={"probes": host(exact_probes),
                "list_rows": np.bincount(host(cand[:, 0]),
                                         minlength=nlist),
                "ambiguous": int((may_p.sum(1) > nprobe).sum()),
                "assign_unsure": int((poss[:, 1:].any(1)).sum()),
                "assign_ties": ties,
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
