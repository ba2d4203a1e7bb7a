"""Batched graph ANN: CAGRA-style build and fixed-iteration greedy walk.

The counterpart of ``duckdb_faiss_ext_tpu/ops/graph.py``: a fixed-degree
neighbour graph (the HNSW / NSG surface's graph regime, models/hnsw.py),
searched by a batched walk whose every step is a dense tensor op.

Build (``build_graph``): a k-NN graph at an intermediate degree, then
``augment_graph``'s forward-first prune with reverse-edge backfill.  The
k-NN graph is exact up to ``exact_max`` rows: a self-search through the
fused distance + top-k kernel K1 (ops/flat_topk.py) at k = degree + 1,
each row's own position dropped.  K1 ranks equal scores by ascending
position, so when a row has exact duplicates its own position may fall
past the degree + 1 kept; the first ``degree`` of the rest are then the
answer, as they are when it is dropped.  Past ``exact_max`` rows the build
is clustered (each row scanned against the members of its two nearest
k-means lists), refined by synchronous NN-descent rounds, and pruned with
room for reverse edges (``clustered_fkeep``).

Walk (``graph_search``): a pool of ``pool`` entries a query, seeded by an
exact scan of a strided corpus sample; each of ``iters`` iterations expands
the best ``width`` unexpanded entries, drops the neighbours already in the
pool or earlier in the frontier (a stable sort marks first occurrences;
the JAX package built a (B, width·deg, width·deg) equality block), scores
the rest in fp32 and keeps the best ``pool`` of pool ∪ candidates.  A
selector's mask applies at extraction, not during traversal (FAISS HNSW
semantics); in fast mode the pool is rescored in full fp32 first.

SQ-coded build and walk (``codec`` = "sq8" / "sq6" / "sq4" with the
trained ``vmin`` / ``scale``): the buffer holds row-major packed codes in
the packing of ops/sq.py instead of fp32 rows, and every row fetch
decodes in place (``fetch_rows``), in the clustered scan, NN-descent and
the walk, whose final pool is rescored in full fp32 against the decoded
rows.  Distances are exact against the quantized rows, as IVF,SQ's are,
and the buffer is the codes' size: 8,841,823 x 1536 rows are 54.3 GB in
fp32, 13.6 GB as sq8, 10.2 GB as sq6 and 6.8 GB as sq4.  The factory does
not reach it (``HNSW[M],SQ8`` stores fp32 rows, as in the JAX package);
tools/marco_graph.py drives it.

Every top-k here ranks equal scores by lower index, as ``lax.top_k`` does.
Not ported, being TPU workarounds: the packed neighbourhoods and their
int8 / int4 codecs (a gather-descriptor cost on v5e), the lane-folded
adjacency (an XLA lane-padding copy of the gather operand) and the
host-chunked dispatches (the TPU worker's watchdog).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import full_fp32, next_pow2
from ..utils.profiling import span
from . import flat_topk
from .distance import pairwise_tile
from .flat_search import SIMILARITY_METRICS, exact_topk
from .kmeans import kmeans_fit, subsample_for_training
from .sq import sq_decode

_NEG_INF = float("-inf")

#: corpus rows up to which ``build_graph`` takes the exact k-NN scan
EXACT_MAX = 2_000_000
#: queries a K1 launch of the exact build scans
_KNN_BLOCK = 8192
#: rows the walk's seed scan samples (the JAX package's rule)
WALK_SEEDS = 8192


def first_occurrence(vals: torch.Tensor) -> torch.Tensor:
    """(R, W) bool: True where an entry's value does not occur earlier in
    its row."""
    srt, order = torch.sort(vals, dim=1, stable=True)
    first = torch.ones_like(vals, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return torch.empty_like(first).scatter_(1, order, first)


def fetch_rows(xb: torch.Tensor, ids: torch.Tensor, codec: str | None = None,
               vmin: torch.Tensor | None = None,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """Rows ``ids`` (any shape, every id valid) of ``xb`` as fp32
    (*ids.shape, d): a gather, decoded in place when ``codec`` marks ``xb``
    as packed SQ codes."""
    rows = xb[ids.reshape(-1)]
    if codec is not None:
        rows = sq_decode(rows, vmin, scale, codec)
    return rows.reshape(*ids.shape, rows.shape[-1])


def batched_scores(xq: torch.Tensor, vecs: torch.Tensor, metric: str,
                   vn: torch.Tensor | None = None) -> torch.Tensor:
    """(B, d) queries against (B, M, d) gathered rows → (B, M) max-oriented
    scores (negated squared L2); ``vn`` the rows' squared norms where the
    caller has them."""
    xy = torch.bmm(vecs, xq[:, :, None])[..., 0]
    if metric == "INNER_PRODUCT":
        return xy
    qn = (xq * xq).sum(-1, keepdim=True)
    if vn is None:
        vn = (vecs * vecs).sum(-1)
    return -(qn - 2.0 * xy + vn).clamp(min=0.0)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def build_knn_graph(xb: torch.Tensor, nvalid: int, degree: int,
                    metric: str) -> torch.Tensor:
    """Exact k-NN graph of rows [0, nvalid) of ``xb`` (a (cap, d) fp32
    buffer): (nvalid, degree) int32 on xb's device, each row's best
    ``degree`` other rows, ties by ascending position, -1 where fewer
    exist.  K1 at k = degree + 1 (its plain version on CPU tensors)."""
    n = int(nvalid)
    out = torch.full((n, degree), -1, dtype=torch.int32, device=xb.device)
    if n == 0 or degree <= 0:
        return out
    k = min(degree + 1, n)
    w = min(degree, k)
    for q0 in range(0, n, _KNN_BLOCK):
        q1 = min(q0 + _KNN_BLOCK, n)
        _, pos = flat_topk.flat_topk(xb, n, xb[q0:q1], k, metric)
        rows = torch.arange(q0, q1, device=xb.device)[:, None]
        is_self = pos == rows
        # The row itself moves to the end; without it the (degree+1)-th goes.
        order = torch.sort(is_self.to(torch.uint8), dim=1, stable=True)[1]
        pos = pos.gather(1, order).masked_fill(is_self.gather(1, order), -1)
        out[q0:q1, :w] = pos[:, :w]
    return out


#: rows a block of augment_graph's row-local stage
AUGMENT_BLOCK = 1 << 18


def reverse_lists(knn: torch.Tensor, degree: int) -> torch.Tensor:
    """Each row's first ``degree`` reverse edges ((n, degree) int32, -1
    padded): the rows u whose k-NN list names it, ordered by the rank it
    holds in u's list, then by u.  Taken a rank (a column of ``knn``) at a
    time, in ascending order, each column's edges sorted stably by
    destination, so the sources of one destination arrive in (rank,
    source) order; nothing holds more than a column of edges."""
    n, kd = knn.shape
    dev = knn.device
    rev = torch.full((n, degree), -1, dtype=torch.int32, device=dev)
    filled = torch.zeros(n, dtype=torch.int64, device=dev)
    src_all = torch.arange(n, dtype=torch.int32, device=dev)
    for r in range(kd):
        col = knn[:, r]
        live = col >= 0
        dst, order = torch.sort(col[live].long(), stable=True)
        if dst.numel() == 0:
            continue
        src = src_all[live][order]
        at = torch.arange(dst.numel(), device=dev)
        start = torch.ones_like(dst, dtype=torch.bool)
        start[1:] = dst[1:] != dst[:-1]
        first = torch.cummax(torch.where(start, at, 0), 0).values
        slot = filled[dst] + (at - first)
        keep = slot < degree
        rev[dst[keep], slot[keep]] = src[keep]
        filled += torch.bincount(dst, minlength=n)
    return rev


def augment_graph(knn: torch.Tensor, degree: int,
                  fkeep: int | None = None) -> torch.Tensor:
    """Rank-based prune + reverse-edge backfill of an (n, kd) k-NN graph:
    each row keeps its best ``fkeep`` forward edges (default ``degree``),
    then the reverse edges (v in u's list puts u in v's, in forward-rank
    order), then the rest of its forward edges, first occurrences only and
    never itself, cut to ``degree`` and padded with -1.  The JAX package's
    host numpy function on the tensor's device; the result is byte-equal
    to it.  Everything is int32 and blocked: the reverse lists a rank at a
    time (``reverse_lists``), the rest in blocks of AUGMENT_BLOCK rows (at
    8,841,823 x 192 an int64 tensor over every edge is 13.6 GB)."""
    n, kd = knn.shape
    dev = knn.device
    if n == 0:
        return torch.empty((0, degree), dtype=torch.int32, device=dev)
    fkeep = max(1, min(degree, degree if fkeep is None else fkeep))
    rev = reverse_lists(knn, degree)
    out = torch.empty((n, degree), dtype=torch.int32, device=dev)
    for r0 in range(0, n, AUGMENT_BLOCK):
        r1 = min(r0 + AUGMENT_BLOCK, n)
        fwd = knn[r0:r1].to(torch.int32)
        cand = torch.cat([fwd[:, :fkeep], rev[r0:r1], fwd[:, fkeep:]], 1)
        w = cand.shape[1]
        cand = cand.masked_fill(
            cand == torch.arange(r0, r1, device=dev)[:, None], -1)
        keep_mask = first_occurrence(cand) & (cand >= 0)
        # Kept entries in their column order, the rest after them.
        col = torch.arange(w, device=dev).expand(r1 - r0, w)
        take = torch.sort(torch.where(keep_mask, col, w + 1), dim=1,
                          stable=True)[1][:, :degree]
        sel = cand.gather(1, take)
        out[r0:r1] = torch.where(keep_mask.gather(1, take), sel, -1)
    return out


def membership_table(a12: np.ndarray, nlist: int, degree: int,
                     lmax_factor: float = 1.5) -> tuple[np.ndarray, int]:
    """Padded top-2 list-membership table (host numpy, as in the JAX
    package): primary memberships slot first in each list, secondary ones
    overflow first; lmax ≥ degree.  Returns ((nlist, lmax) int32 row ids
    or -1, lmax)."""
    n = a12.shape[0]
    entries_list = a12.T.reshape(-1)     # primaries [0..n), then secondaries
    entries_row = np.tile(np.arange(n, dtype=np.int64), 2)
    order = np.argsort(entries_list, kind="stable")
    el, er = entries_list[order], entries_row[order]
    grp = np.searchsorted(el, np.arange(nlist))
    slot = np.arange(el.shape[0]) - grp[el]
    avg = max(1, (2 * n) // nlist)
    lmax = next_pow2(max(min(max(int(lmax_factor * avg), degree + 2),
                             4 * avg), degree))
    keep = slot < lmax
    table = np.full((nlist, lmax), -1, np.int32)
    table[el[keep], slot[keep]] = er[keep]
    return table, lmax


def top2_assign(x: torch.Tensor, cents: torch.Tensor,
                metric: str) -> torch.Tensor:
    """(n, 2) int64: each row's two best centroids by the metric (lower
    centroid on ties), in blocks of at most 2^27 scores."""
    sim = metric in SIMILARITY_METRICS
    block = max(1024, (1 << 27) // max(cents.shape[0], 1))
    out = []
    for s in range(0, x.shape[0], block):
        dist = pairwise_tile(x[s:s + block], cents, metric)
        out.append(exact_topk(dist if sim else -dist, 2)[1])
    return torch.cat(out)


def live_table(table) -> tuple[np.ndarray, np.ndarray]:
    """A membership table ((nlist, lmax) row ids, -1 empty) with each list's
    members moved to the front in their order, and each list's count: host
    numpy (the scan slices each list to its members)."""
    table = np.asarray(table.cpu() if torch.is_tensor(table) else table)
    valid = table >= 0
    if (valid[:, 1:] & ~valid[:, :-1]).any():
        order = np.argsort(~valid, axis=1, kind="stable")
        table = np.take_along_axis(table, order, 1)
    return table, valid.sum(1)


def clustered_knn_scan(x: torch.Tensor, table, degree: int, metric: str,
                       codec: str | None = None,
                       vmin: torch.Tensor | None = None,
                       scale: torch.Tensor | None = None,
                       progress=None) -> torch.Tensor:
    """Each list's members scanned against each other once, in list
    order; a member's running best ``degree`` (it sits in two lists) is
    merged read-modify-write.  ``table`` is the (nlist, lmax) membership
    table (numpy or tensor); each list is sliced to its members, which
    gives what the padded scan gives.  ``x`` is (n, d) fp32 rows, or (n, w)
    packed codes with ``codec`` set, decoded a list at a time.
    ``progress(done, nlist)`` is called every 4,096 lists.  Returns (n,
    degree) int32, -1 missing."""
    n = x.shape[0]
    dev = x.device
    sim = metric in SIMILARITY_METRICS
    table, counts = live_table(table)
    table_dev = torch.from_numpy(table).to(dev)
    vals = torch.full((n, degree), _NEG_INF, device=dev)
    ids = torch.full((n, degree), -1, dtype=torch.int32, device=dev)
    for lst, cnt in enumerate(counts.tolist()):
        if progress is not None and lst % 4096 == 0:
            progress(lst, len(counts))
        if cnt == 0:
            continue
        rows = table_dev[lst, :cnt].long()
        v = fetch_rows(x, rows, codec, vmin, scale)
        dist = pairwise_tile(v, v, metric)
        score = (dist if sim else -dist).masked_fill(
            rows[:, None] == rows[None, :], _NEG_INF)
        lv, li = exact_topk(score, min(degree, cnt))
        cand = torch.where(torch.isneginf(lv), -1, rows[li]).to(torch.int32)
        cur_v, cur_i = vals[rows], ids[rows]
        dup = (cand[:, :, None] == cur_i[:, None, :]).any(-1)
        lv = lv.masked_fill(dup | (cand < 0), _NEG_INF)
        mv, sel = exact_topk(torch.cat([cur_v, lv], 1), degree)
        mi = torch.cat([cur_i, cand], 1).gather(1, sel)
        vals[rows] = mv
        ids[rows] = mi.masked_fill(torch.isneginf(mv), -1)
    if progress is not None:
        progress(len(counts), len(counts))
    return ids


def build_knn_graph_clustered(xb: torch.Tensor, nvalid: int, degree: int,
                              metric: str, nlist: int | None = None,
                              seed: int = 0, codec: str | None = None,
                              vmin: torch.Tensor | None = None,
                              scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Approximate k-NN graph of rows [0, nvalid) of ``xb``: k-means on a
    subsample (the port's own k-means, so its lists differ from the JAX
    package's), every row in its two nearest lists, each list scanned
    once (n²·4/nlist work).  A row left in no list (both overflowed) is
    seeded with members of its primary list.  With ``codec`` set, ``xb``
    holds packed codes: training, assignment and scan see the decoded
    rows.  (nvalid, degree) int32."""
    n = int(nvalid)
    dev = xb.device
    if n == 0:
        return torch.empty((0, degree), dtype=torch.int32, device=dev)
    x = xb[:n]
    nlist = nlist or max(16, next_pow2(max(1, int(np.sqrt(n)))))
    ntrain = min(n, max(subsample_for_training(n, nlist), 4 * nlist))
    rng = np.random.default_rng(seed)
    sample = (torch.from_numpy(rng.choice(n, size=ntrain, replace=False))
              .to(dev) if ntrain < n else torch.arange(n, device=dev))
    with full_fp32():
        cents, _ = kmeans_fit(fetch_rows(x, sample, codec, vmin, scale),
                              nlist, seed=seed)
    block = max(1024, (1 << 27) // max(nlist, 1))
    a12 = torch.cat([top2_assign(fetch_rows(x, torch.arange(
        s, min(s + block, n), device=dev), codec, vmin, scale), cents, metric)
        for s in range(0, n, block)]).cpu().numpy()
    table, lmax = membership_table(a12, nlist, degree)
    ids = clustered_knn_scan(x, table, degree, metric, codec, vmin, scale)
    missing = torch.nonzero((ids < 0).all(1))[:, 0]
    if missing.numel():
        m = missing.cpu().numpy()
        fill = table[a12[m, 0], :min(degree, lmax)]
        fill = np.where(fill == m[:, None], -1, fill)
        ids[missing, :fill.shape[1]] = torch.from_numpy(fill).to(dev)
    return ids


#: fp32 elements of the decoded candidate rows an NN-descent block holds
DESCENT_BLOCK_ELEMS = 1 << 28
#: rows whose candidate lists an NN-descent step builds and compacts at once
DESCENT_ROWS = 8192


def nn_descent_round(x: torch.Tensor, knn: torch.Tensor, metric: str,
                     sample: int, codec: str | None = None,
                     vmin: torch.Tensor | None = None,
                     scale: torch.Tensor | None = None,
                     progress=None) -> torch.Tensor:
    """One synchronous NN-descent round: each row scores its neighbours'
    first ``sample`` neighbours and keeps the best ``deg`` of current ∪
    candidates (current entries first, so they win equal scores).  Reads
    the input graph only.  A step of DESCENT_ROWS rows drops each row's
    repeated, missing and own candidates and moves the rest to the front
    in their order, so that only they are gathered (the order, and with it
    every tie, is kept); the rows, taken by their count of candidates,
    most first, fetch them (decoded in place with ``codec`` set, ``x`` then
    packed codes) and score them in blocks of at most
    ``DESCENT_BLOCK_ELEMS`` fp32 elements (1 GiB), each block as wide as
    its first row's candidates.  ``progress(done, n)``
    is called after each 262,144 rows."""
    n, deg = knn.shape
    dev = x.device
    d = x.shape[1] if codec is None else vmin.shape[0]
    head = knn[:, :sample]
    out = torch.empty_like(knn)
    for q0 in range(0, n, DESCENT_ROWS):
        q1 = min(q0 + DESCENT_ROWS, n)
        cur = knn[q0:q1].long()
        nbr2 = head[cur.clamp(min=0)].long()
        nbr2 = nbr2.masked_fill(cur[:, :, None] < 0, -1)
        cand = torch.cat([cur, nbr2.reshape(q1 - q0, -1)], 1)
        rows = torch.arange(q0, q1, device=dev)
        cand = cand.masked_fill((cand == rows[:, None])
                                | ~first_occurrence(cand), -1)
        dead = (cand < 0).to(torch.uint8)
        live = (1 - dead).sum(1)
        # rows by their live count, most first, so that each scoring block
        # gathers no wider than its first row's candidates
        order = torch.sort(live, descending=True, stable=True)[1]
        widths = live[order].tolist()
        width = max(deg, widths[0])
        cand = cand.gather(1, torch.sort(dead, dim=1, stable=True)[1][
            :, :width])[order]
        rows = rows[order]
        scores = torch.full(cand.shape, _NEG_INF, device=dev)
        s0 = 0
        while s0 < q1 - q0 and widths[s0]:
            w = widths[s0]
            s1 = min(q1 - q0, s0 + max(1, DESCENT_BLOCK_ELEMS // (w * d)))
            scores[s0:s1, :w] = batched_scores(
                fetch_rows(x, rows[s0:s1], codec, vmin, scale),
                fetch_rows(x, cand[s0:s1, :w].clamp(min=0), codec, vmin,
                           scale), metric)
            s0 = s1
        vals, sel = exact_topk(scores.masked_fill(cand < 0, _NEG_INF), deg)
        out[rows] = cand.gather(1, sel).masked_fill(
            torch.isneginf(vals), -1).to(knn.dtype)
        if progress is not None and (q1 // 262_144 > q0 // 262_144
                                     or q1 == n):
            progress(q1, n)
    return out


def refine_knn_graph(xb: torch.Tensor, nvalid: int, knn: torch.Tensor,
                     metric: str, rounds: int = 1, sample: int = 8,
                     codec: str | None = None,
                     vmin: torch.Tensor | None = None,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """``rounds`` NN-descent rounds over an approximate k-NN graph of rows
    [0, nvalid) of ``xb`` (the CAGRA build recipe); ``xb`` packed codes
    with ``codec`` set.  Each round's input graph is dropped once the
    next has been made: where the caller keeps no reference to ``knn``,
    no more than two graphs are held at once."""
    n, deg = knn.shape
    x = xb[:int(nvalid)]
    for _ in range(rounds if n else 0):
        knn = nn_descent_round(x, knn, metric, min(sample, deg), codec, vmin,
                               scale)
    return knn


def clustered_fkeep(degree: int) -> int:
    """Forward edges the clustered build's prune keeps before the reverse
    edges (``augment_graph``'s ``fkeep``): three quarters of the degree.
    Its approximate k-NN lists are wider than the degree, so keeping every
    forward edge (the exact build's rule, the JAX package's) fills each
    row and leaves no slot for a reverse edge, and a row that no forward
    list names is reachable only as a seed: 2.06% of the rows at
    8,841,823 x 1536, degree 128, none with a quarter (or CAGRA's half)
    left to reverse edges."""
    return max(1, degree - degree // 4)


def clustered_seeds(n: int) -> int:
    """Rows the walk's seed scan samples over a clustered build of ``n``
    rows (``graph_search``'s ``nseed``): one in 64, and never fewer than
    ``WALK_SEEDS``.  The clustered k-NN graph links a row within its own
    cluster and seldom beyond, so a walk reaches a cluster only from a
    seed inside it, and a cluster of m rows holds none about e^(−m·s/n)
    of the time with s seeds: at 8,841,823 x 1536 over 4,096 uneven
    clusters, 8,192 seeds left 24% of the clusters unfound and 12.7% of
    the queries at recall 0."""
    return max(WALK_SEEDS, int(n) // 64)


def build_graph(xb: torch.Tensor, nvalid: int, degree: int, metric: str,
                intermediate: int | None = None,
                exact_max: int = EXACT_MAX,
                refine_rounds: int = 2) -> torch.Tensor:
    """CAGRA-style build over rows [0, nvalid) of ``xb``: a k-NN graph at
    ``intermediate`` degree (default 2 x degree), exact up to
    ``exact_max`` rows and clustered + ``refine_rounds`` NN-descent rounds
    beyond, then ``augment_graph`` to ``degree``, forward edges first in
    the exact build and ``clustered_fkeep`` of them in the clustered one.
    Each intermediate graph is dropped once the next stage has made its
    own; the stages run in the spans ``models.graph_knn``,
    ``models.graph_descent`` and ``models.graph_augment``.  (nvalid,
    degree) int32 on xb's device."""
    n = int(nvalid)
    inter = intermediate or min(max(degree * 2, degree + 1), max(1, n - 1))
    with full_fp32():
        if n <= exact_max:
            with span("models.graph_knn"):
                knn = build_knn_graph(xb, n, inter, metric)
            fkeep = None
        else:
            with span("models.graph_knn"):
                stage = [build_knn_graph_clustered(xb, n, inter, metric)]
            with span("models.graph_descent"):
                # popped, so that refine_knn_graph holds the only reference
                knn = refine_knn_graph(xb, n, stage.pop(), metric,
                                       rounds=max(1, refine_rounds))
            fkeep = clustered_fkeep(degree)
        with span("models.graph_augment"):
            return augment_graph(knn, degree, fkeep)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def default_iters(pool: int, width: int, deg: int) -> int:
    """Walk length: enough iterations to expand the whole pool once, plus
    slack to reach the neighbourhood (the JAX package's rule)."""
    del deg
    return max(4, int(np.ceil(pool / max(width, 1))) + 2)


def graph_search(xb: torch.Tensor, graph: torch.Tensor, xq: torch.Tensor,
                 nvalid: int, k: int, metric: str, *, pool: int = 64,
                 width: int = 8, iters: int | None = None,
                 mask: torch.Tensor | None = None, rerank: bool = False,
                 codec: str | None = None, vmin: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None,
                 nseed: int = WALK_SEEDS):
    """Batched greedy walk over ``graph`` ((cap, deg) int32, -1 padded, its
    rows those of the (cap, d) fp32 buffer ``xb``) for the (B, d) queries
    ``xq``; nodes at or past ``nvalid`` are never seeded.  Returns
    max-oriented (scores (B, k), positions (B, k) int32), (-inf, -1) where
    missing, as ``flat_search.search_scan`` does.  The pool is seeded from
    an exact scan of about ``nseed`` evenly strided rows.  ``mask``
    ((cap,) bool) filters at extraction; ``rerank`` rescores the final
    pool in full fp32 (fast mode, where the walk's products may be TF32).
    With ``codec`` set, ``xb`` is (cap, w) packed SQ codes: the seed
    sample and every fetch decode in place, and the pool is always
    rescored in full fp32 against the decoded rows (scores exact against
    the quantized rows)."""
    pool = max(pool, k)
    deg = graph.shape[1]
    if iters is None:
        iters = default_iters(pool, width, deg)
    b = xq.shape[0]
    dev = xq.device
    sim = metric in SIMILARITY_METRICS
    rerank = rerank or codec is not None
    vn = (xb * xb).sum(1) if metric == "L2" and codec is None else None

    def scores_of(ids):
        safe = ids.clamp(min=0)
        return batched_scores(xq, fetch_rows(xb, safe, codec, vmin, scale),
                              metric, None if vn is None else vn[safe])

    # Informed init: an exact scan of every stride-th node (stride from
    # the padded graph rows), its best `pool` seed the pool.
    stride = max(1, graph.shape[0] // max(int(nseed), 1))
    sids = torch.arange(0, xb.shape[0], stride, device=dev)
    seeds = xb[::stride]
    if codec is not None:
        seeds = sq_decode(seeds, vmin, scale, codec)
    dist = pairwise_tile(xq, seeds, metric)
    sscore = (dist if sim else -dist).masked_fill(sids[None, :] >= nvalid,
                                                  _NEG_INF)
    if sscore.shape[1] < pool:
        fill = pool - sscore.shape[1]
        sscore = torch.cat([sscore, torch.full((b, fill), _NEG_INF,
                                               device=dev)], 1)
        sids = torch.cat([sids, torch.zeros(fill, dtype=sids.dtype,
                                            device=dev)])
    scores, sel = exact_topk(sscore, pool)
    ids = sids[sel].masked_fill(torch.isneginf(scores), -1)
    expanded = torch.zeros((b, pool), dtype=torch.bool, device=dev)

    for _ in range(int(iters)):
        # Frontier: the best `width` unexpanded pool entries.
        fvals, fsel = exact_topk(scores.masked_fill(expanded, _NEG_INF),
                                 width)
        fids = ids.gather(1, fsel)
        alive = (fids >= 0) & ~torch.isneginf(fvals)
        expanded = expanded.scatter(1, fsel, True)
        nbrs = graph[fids.clamp(min=0)].long()
        nbrs = nbrs.masked_fill(~alive[:, :, None], -1).reshape(b, -1)
        # Drop neighbours already in the pool or earlier in the frontier.
        first = first_occurrence(torch.cat([ids, nbrs], 1))[:, ids.shape[1]:]
        cand = nbrs.masked_fill(~first | (nbrs < 0), -1)
        cscores = scores_of(cand).masked_fill(cand < 0, _NEG_INF)
        scores, sel = exact_topk(torch.cat([scores, cscores], 1), pool)
        ids = torch.cat([ids, cand], 1).gather(1, sel)
        expanded = torch.cat([expanded, torch.zeros_like(cand, dtype=torch.bool)],
                             1).gather(1, sel)

    if rerank:
        with full_fp32():
            scores = scores_of(ids).masked_fill(ids < 0, _NEG_INF)
    valid = ids >= 0
    if mask is not None:
        valid &= mask[ids.clamp(min=0)].to(torch.bool)
    if rerank or mask is not None:
        out_s, sel = exact_topk(scores.masked_fill(~valid, _NEG_INF), k)
        out_i = ids.gather(1, sel).masked_fill(torch.isneginf(out_s), -1)
        return out_s, out_i.to(torch.int32)
    out_i = ids[:, :k]
    return (scores[:, :k].masked_fill(out_i < 0, _NEG_INF),
            out_i.to(torch.int32))
