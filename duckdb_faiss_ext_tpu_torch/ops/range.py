"""Range search: all neighbors within a radius (faiss::Index::range_search).

The counterpart of ``duckdb_faiss_ext_tpu/ops/range.py``.  Not reachable
through the reference's SQL surface (its functions cover k-NN only) but
part of the FAISS capability set behind it, served as
``api.faiss_range_search`` and the SQL route of ``sql.dispatch``.

Result sizes depend on the data.  The index's device computes each dense
distance tile (the same pairwise tile as the plain k-NN scan, chunked over
the corpus, or one query chunk against its probed lists for IVF) and
thresholds it there: ``torch.nonzero`` gives each tile's (query, row)
hits, which stay on the device until the last tile; one fetch then
brings the hits to the host, and ``bincount`` / ``cumsum`` over their
query ids give the CSR ``lims``.  The JAX package thresholded each
fetched tile on the host in a per-query loop; the (label, distance) pairs
of every query are the same.

Strictness is FAISS's: dissimilarity metrics keep d < radius, similarity
metrics keep d > radius; a selector's ``passing`` rows are applied to the
same hits.  Within a query's segment the dense scans list their rows in
ascending storage position (the JAX package's order); the IVF scan lists
them by probe rank, then by position within the list.  FAISS leaves that
order unspecified.

The tiles follow the precision mode (TF32 in fast mode), as the JAX
package's follow ``config.precision``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .distance import elementwise_scores, pairwise_tile
from .flat_search import SIMILARITY_METRICS
from .ivf_scan import slice_probed_lists


class RangeSearchResult(NamedTuple):
    """CSR result: query q's neighbors are labels[lims[q]:lims[q+1]]
    (faiss::RangeSearchResult layout)."""

    lims: np.ndarray        # (nq + 1,) int64
    labels: np.ndarray      # (nres,) int64
    distances: np.ndarray   # (nres,) float32


def empty_range_result(nq: int) -> RangeSearchResult:
    return RangeSearchResult(np.zeros((nq + 1,), np.int64),
                             np.empty((0,), np.int64),
                             np.empty((0,), np.float32))


def choose_range_chunk(cap: int) -> int:
    """Corpus rows per dense tile (the JAX package's rule); the last tile
    is simply shorter."""
    return max(1, min(cap, 1 << 16))


def range_num_chunks(cap: int, chunk: int) -> int:
    return -(-cap // chunk)


def _hits(dist, radius: float, metric: str):
    return dist > radius if metric in SIMILARITY_METRICS else dist < radius


def _to_csr(qs, rows, dists, nq: int) -> tuple:
    """Hits grouped by query (``qs`` non-decreasing) → (lims, rows,
    distances) on the host, one fetch."""
    counts = torch.bincount(qs, minlength=nq)
    lims = np.zeros((nq + 1,), np.int64)
    np.cumsum(counts.cpu().numpy(), out=lims[1:])
    return (lims, rows.cpu().numpy().astype(np.int64),
            dists.cpu().numpy().astype(np.float32))


def range_scan_dense(get_tile, nchunks: int, chunk: int, ntotal: int,
                     nq: int, radius: float, metric: str,
                     passing: np.ndarray | None) -> RangeSearchResult:
    """Threshold dense tiles chunk by chunk on their device.

    ``get_tile(i)`` → (nq_pad, chunk) fp32 distances of corpus rows
    [i·chunk, (i+1)·chunk); ``passing`` is the selector's per-row boolean
    (length ntotal) or None.  Labels are storage positions."""
    qs, rows, dists = [], [], []
    keep = None
    for i in range(nchunks):
        base = i * chunk
        nrows = min(chunk, ntotal - base)
        if nrows <= 0:
            break
        tile = get_tile(i)[:nq, :nrows]
        hit = _hits(tile, radius, metric)
        if passing is not None:
            if keep is None:
                keep = torch.from_numpy(np.asarray(passing, bool)).to(
                    tile.device)
            hit &= keep[None, base:base + nrows]
        q, r = torch.nonzero(hit, as_tuple=True)
        qs.append(q)
        rows.append(r + base)
        dists.append(tile[q, r])
    if not qs:
        return empty_range_result(nq)
    q = torch.cat(qs)
    # Chunks run over the corpus: a stable sort by query groups the hits
    # and keeps each query's rows ascending.
    order = torch.sort(q, stable=True).indices
    return RangeSearchResult(*_to_csr(q[order], torch.cat(rows)[order],
                                      torch.cat(dists)[order], nq))


def dense_range_search(index, xq, radius: float, selector, buf, rows):
    """Range search of a dense-storage index (Flat, SQ, PQ / RQ): the
    queries padded to their bucket on the index's device, then
    ``range_scan_dense`` over chunks of the padded buffer ``buf``, each
    turned into fp32 rows by ``rows(chunk)`` (a decode, or a cast) and
    scored by the plain pairwise tile; the selector filters
    ``index.row_labels()``.  Labels are storage positions."""
    from ..models.base import as_matrix
    from ..utils.transfer import upload_query_batch

    xq = as_matrix(xq, index.d)
    nq = xq.shape[0]
    if nq == 0 or index.ntotal == 0:
        return empty_range_result(nq)
    cap = buf.shape[0]
    chunk = choose_range_chunk(cap)
    xq_dev = upload_query_batch(xq, buf.device)
    metric = index.metric.name

    def get_tile(i):
        return pairwise_tile(xq_dev, rows(buf[i * chunk:(i + 1) * chunk]),
                             metric, index.metric_arg)

    return range_scan_dense(
        get_tile, range_num_chunks(cap, chunk), chunk, index.ntotal, nq,
        float(radius), metric,
        selector.contains(index.row_labels()) if selector is not None
        else None)


def ivf_range_chunk(xb_sorted, offsets, counts, probes_c, xq_c, metric: str,
                    metric_arg: float, *, lmax: int, decode=None,
                    centroids=None):
    """Distances of one query chunk against its probed lists' members.

    The probed lists are contiguous windows of the row-sorted buffer
    (``slice_probed_lists``); with ``decode`` their stored codes are
    decoded (only these windows), and with ``centroids`` (residual codecs)
    each window's list centroid is added back.  Returns (dist (qc,
    nprobe·L), cand (qc, nprobe·L) sorted-row positions); slots outside a
    list's window get a radius-failing distance (+inf for dissimilarity,
    -inf for similarity).  L2 is taken in difference form, inner product
    as an elementwise fp32 dot."""
    qc, nprobe = probes_c.shape
    d = xq_c.shape[1]
    xc, cand, valid = slice_probed_lists(xb_sorted, offsets, counts,
                                         probes_c, lmax=lmax)
    L = xc.shape[2]
    if decode is not None:
        xc = decode(xc.reshape(qc * nprobe * L, -1)).reshape(qc, nprobe, L, d)
    if centroids is not None:
        xc = xc + centroids[probes_c.long()][:, :, None, :]
    xc = xc.reshape(qc, nprobe * L, d)
    cand = cand.reshape(qc, nprobe * L)
    valid = valid.reshape(qc, nprobe * L)
    if metric == "INNER_PRODUCT":
        dist = (xc * xq_c[:, None, :]).sum(-1)
    elif metric == "L2":
        diff = xc - xq_c[:, None, :]
        dist = (diff * diff).sum(-1)
    else:
        dist = elementwise_scores(xq_c[:, None, :], xc, metric, metric_arg)
    bad = float("-inf") if metric in SIMILARITY_METRICS else float("inf")
    return torch.where(valid, dist, bad), cand


def ivf_range_scan(xb_sorted, offsets, counts, probe_ids, xq, nq: int,
                   radius: float, metric: str, metric_arg: float, *,
                   lmax: int, labels_sorted: np.ndarray,
                   passing: np.ndarray | None = None, decode=None,
                   centroids=None) -> RangeSearchResult:
    """Range search over the probed lists, query chunk by query chunk
    (each chunk's gathered rows bounded to 2^26 values), thresholded on
    the device.  ``passing`` is the selector's boolean over the sorted
    rows; labels come from ``labels_sorted``."""
    d = xq.shape[1]
    ncand = probe_ids.shape[1] * min(lmax, xb_sorted.shape[0])
    qc = 1
    while qc * 2 <= min(max(1, (1 << 26) // max(ncand * d, 1)), nq):
        qc *= 2
    keep = (torch.from_numpy(np.asarray(passing, bool)).to(xq.device)
            if passing is not None else None)
    qs, rows, dists = [], [], []
    for q0 in range(0, nq, qc):
        q1 = min(q0 + qc, nq)
        dist, cand = ivf_range_chunk(
            xb_sorted, offsets, counts, probe_ids[q0:q1], xq[q0:q1], metric,
            metric_arg, lmax=lmax, decode=decode, centroids=centroids)
        hit = _hits(dist, radius, metric)
        if keep is not None:
            n = keep.shape[0]
            hit &= (cand < n) & keep[cand.clamp(max=n - 1)]
        q, j = torch.nonzero(hit, as_tuple=True)
        qs.append(q + q0)
        rows.append(cand[q, j])
        dists.append(dist[q, j])
    lims, pos, dist = _to_csr(torch.cat(qs), torch.cat(rows),
                              torch.cat(dists), nq)
    return RangeSearchResult(lims, labels_sorted[pos].astype(np.int64), dist)


def dedup_range_labels(res: RangeSearchResult,
                       similarity: bool) -> RangeSearchResult:
    """Keep the best entry of each (query, label) pair of a CSR result
    (SOAR stores a row in two lists; codec storages encode the two copies
    against different centroids, so their distances may differ), in the
    surviving entries' original order."""
    nq = res.lims.shape[0] - 1
    nres = res.labels.shape[0]
    if nres == 0:
        return res
    qid = np.repeat(np.arange(nq, dtype=np.int64), np.diff(res.lims))
    dkey = -res.distances if similarity else res.distances
    order = np.lexsort((dkey, res.labels, qid))
    q_s, l_s = qid[order], res.labels[order]
    first = np.ones((nres,), bool)
    first[1:] = (q_s[1:] != q_s[:-1]) | (l_s[1:] != l_s[:-1])
    keep = np.sort(order[first])
    lims = np.zeros((nq + 1,), np.int64)
    np.cumsum(np.bincount(qid[keep], minlength=nq), out=lims[1:])
    return RangeSearchResult(lims, res.labels[keep], res.distances[keep])
