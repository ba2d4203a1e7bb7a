"""IVF scans in plain torch: the sorted+gather scans, the spill scan and
the top-k merge.

Counterparts of ``duckdb_faiss_ext_tpu/ops/ivf_scan.py`` (``ivf_search``,
``ivf_sq_search``, ``ivf_sq_int8_search``, ``ivf_pq_search``,
``slice_probed_lists``, ``choose_q_chunk``, ``ivf_spill_scan`` with its SQ
and PQ / RQ branches, ``merge_topk``): XLA code the JAX package ran outside
any ``pallas_call``, so plain torch here too.

* ``ivf_search`` serves IVF searches that have no padded list layout: the
  seven elementwise metrics, and L2 / inner product when the layout plan
  (models/ivf_layout.py) is None.  The inverted lists are one row-sorted
  corpus buffer plus (offsets, counts) list metadata; each probed list is a
  contiguous (lmax, w) window of it, gathered per query chunk.
  ``ivf_sq_search`` runs it over SQ codes decoded per chunk (the parity
  path of IVF,SQ), ``ivf_pq_search`` over PQ / RQ residual codes decoded
  and added to the probed list's centroid (IVF-PQ / IVF-RQ without a
  layout plan).
* ``ivf_sq_int8_search``: the int8 digit-dot scan over the same sorted
  codes (IVF,SQ with the int8 path active and no layout plan), then the
  exact fp32 rerank.
* ``ivf_spill_scan`` scores the overflow rows of capped lists densely and
  masks them to each query's probe set (SQ rows decoded, or int8-scored
  with a widened pool and an exact rerank; PQ / RQ codes decoded and added
  to their list's centroid); ``merge_topk`` merges its top-k with the
  padded-layout scan's.

Every fp32 score is exact fp32 whatever the precision mode: L2 / inner
product over the gathered candidates are elementwise products summed (no
TF32 matmul), and the spill tile runs with TF32 off.  So the JAX package's
fast-mode in-chunk rerank has nothing to repair here and is not ported.

Exactness: the candidates are exactly the members of the probed lists, so
results match FAISS given the same centroids and assignments.
"""

from __future__ import annotations

import torch

from ..utils.config import full_fp32
from .distance import elementwise_scores, pairwise_tile
from .flat_search import SIMILARITY_METRICS, exact_topk, topk_ordered
from .ivf_sq_scan import exact_rows_scores
from .pq import codec_decode
from .sq import SQ_INT8_SHIFT, sq_decode
from .sq_digits import digit_dots, int8_scores, query_digits
from .sq_spill import spill_rerank_scores

_NEG_INF = float("-inf")


def coarse_topk(xq: torch.Tensor, centroids: torch.Tensor, nprobe: int,
                metric: str, metric_arg: float = 0.0) -> torch.Tensor:
    """Top-``nprobe`` list ids per query, (nq, nprobe) int32, best first;
    equal scores resolve to the lower list id (as ``lax.top_k`` does)."""
    cdist = pairwise_tile(xq, centroids, metric, metric_arg)
    cscore = cdist if metric in SIMILARITY_METRICS else -cdist
    _, ids = exact_topk(cscore, nprobe)
    return ids.to(torch.int32)


def slice_probed_lists(sorted_buf, offsets, counts, probes_c, *, lmax):
    """The probed lists of a query chunk as contiguous windows of the
    row-sorted buffer.

    Returns (xc (qc, nprobe, L, w), pos (qc, nprobe, L) int64 sorted
    positions, valid (qc, nprobe, L) bool).  Lists shorter than L read
    into the next list's rows; those rows are masked invalid."""
    cap = sorted_buf.shape[0]
    L = min(lmax, cap)
    starts_true = offsets.long()[probes_c.long()]          # (qc, nprobe)
    starts = starts_true.clamp(max=cap - L)
    lane = torch.arange(L, device=sorted_buf.device)
    pos = starts[:, :, None] + lane                        # (qc, np, L)
    end = starts_true + counts.long()[probes_c.long()]
    valid = (pos >= starts_true[:, :, None]) & (pos < end[:, :, None])
    return sorted_buf[pos], pos, valid


def choose_q_chunk(nq: int, ncand: int, d: int) -> int:
    """Queries per scan step: bound the gathered (q, ncand, d) fp32 tile."""
    budget = max(1, (1 << 24) // max(ncand * d, 1))
    q = 1
    while q * 2 <= min(budget, nq):
        q *= 2
    return q


def _candidate_distances(xq_c, xc, metric, metric_arg):
    """(qc, ncand) distances of each query against its own candidates."""
    if metric == "INNER_PRODUCT":
        return (xc * xq_c[:, None, :]).sum(-1)
    if metric == "L2":
        qn = (xq_c * xq_c).sum(1, keepdim=True)
        bn = (xc * xc).sum(-1)
        xy = (xc * xq_c[:, None, :]).sum(-1)
        return (qn - 2.0 * xy + bn).clamp(min=0.0)
    return elementwise_scores(xq_c[:, None, :], xc, metric, metric_arg)


def ivf_search(xb_sorted, offsets, counts, centroids, xq, mask, metric_arg,
               *, k, nprobe, metric, q_chunk, lmax, decode=None,
               by_residual=False):
    """Sorted+gather IVF scan.  Returns (scores (nq, k) max-oriented with
    -inf missing, sorted-row positions (nq, k) int32 with -1 missing).
    ``decode`` maps (r, w) stored rows to (r, d) fp32 (None: fp32 rows);
    with ``by_residual`` each probed window's decoded rows are residuals of
    its list and get the list's centroid added (every valid row of the
    window belongs to that list)."""
    nq, d = xq.shape
    nprobe = min(nprobe, centroids.shape[0])
    sim = metric in SIMILARITY_METRICS
    probe_ids = coarse_topk(xq, centroids, nprobe, metric, metric_arg)
    dev = xq.device
    best_s = torch.full((nq, k), _NEG_INF, dtype=torch.float32, device=dev)
    best_p = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for q0 in range(0, nq, q_chunk):
        xq_c = xq[q0:q0 + q_chunk]
        qc = xq_c.shape[0]
        xc, pos, valid = slice_probed_lists(xb_sorted, offsets, counts,
                                            probe_ids[q0:q0 + q_chunk],
                                            lmax=lmax)
        ncand = xc.shape[1] * xc.shape[2]
        if decode is not None:
            xc = decode(xc.reshape(qc * ncand, -1))
        if by_residual:
            probes_c = probe_ids[q0:q0 + q_chunk].long()
            xc = (xc.reshape(qc, probes_c.shape[1], -1, d)
                  + centroids[probes_c][:, :, None, :])
        xc = xc.reshape(qc, ncand, d)
        pos = pos.reshape(qc, ncand)
        valid = valid.reshape(qc, ncand)
        if mask is not None:
            valid = valid & mask[pos]
        dist = _candidate_distances(xq_c, xc, metric, metric_arg)
        score = torch.where(valid, dist if sim else -dist, _NEG_INF)
        s, sel = exact_topk(score, k)
        p = pos.gather(1, sel).to(torch.int32)
        best_s[q0:q0 + qc, :s.shape[1]] = s
        best_p[q0:q0 + qc, :s.shape[1]] = torch.where(torch.isneginf(s), -1, p)
    return best_s, best_p


def ivf_spill_scan(spill_payload, spill_assign, spill_pos, probe_ids, xq,
                   mask, metric_arg, *, k, metric, nlist, sq=None,
                   sq_vmin=None, sq_scale=None, spill_rn=None, spill_rs=None,
                   int8_dot=False, codec=None, codebooks=None,
                   centroids=None):
    """Scan the spill region: rows whose list overflowed the capped padded
    layout, (s_pad, d) fp32 — or (s_pad, w) SQ codes when ``sq`` names the
    codec, or (s_pad, m) PQ / RQ residual codes when ``codec`` does, decoded
    with ``codebooks`` and added to ``centroids[spill_assign]`` — with
    ``spill_pos`` their original row (-1 for padding).  Every
    spill row is scored against every query and kept only where its list
    is among that query's probes (a (nlist, nq) membership table, gathered
    per chunk).  SQ rows are decoded per chunk, or, with ``int8_dot`` and
    the rows' Σ(scale·c)² / Σc, scored by int8 digit dots
    (ops/sq_digits.py) into a pool of ``k_scan`` widened by codec (the
    JAX package's rule) whose rows are then decoded and rescored in fp32.
    Returns (scores (nq, k) max-oriented, original positions (nq, k)
    int32)."""
    nq, d = xq.shape
    s_pad, w = spill_payload.shape
    sim = metric in SIMILARITY_METRICS
    k = min(k, s_pad)
    use_int8 = int8_dot and sq is not None
    if use_int8:
        f, add = (8, 96) if sq == "sq4" else (4, 32)
        k_pool = min(s_pad, max(f * k, k + add))
        shift = SQ_INT8_SHIFT[sq]
        q = query_digits(xq, sq_vmin, sq_scale, metric, sq, w, shift)
        dig2 = q.digits.reshape(1, 2 * nq, -1)
    else:
        k_pool = k
    member = torch.zeros((nlist, nq), dtype=torch.bool, device=xq.device)
    qidx = torch.arange(nq, device=xq.device)[:, None].expand_as(probe_ids)
    member[probe_ids.long(), qidx] = True
    sc = 1 << max(12, min(25 - max(d, 1).bit_length(), 20))
    best_s = torch.full((nq, k_pool), _NEG_INF, dtype=torch.float32,
                        device=xq.device)
    best_i = torch.full((nq, k_pool), -1, dtype=torch.int64,
                        device=xq.device)
    for start in range(0, s_pad, sc):
        chunk = spill_payload[start:start + sc]
        if use_int8:
            dots = digit_dots(chunk[None], dig2, sq, shift)[0] \
                .reshape(nq, 2, -1)
            score = int8_scores(dots[:, 0], dots[:, 1], q.scalars[:, None, :],
                                spill_rs[None, start:start + sc],
                                spill_rn[None, start:start + sc], metric)
        else:
            if sq is not None:
                chunk = sq_decode(chunk, sq_vmin, sq_scale, sq)
            elif codec is not None:
                chunk = (codec_decode(chunk, codebooks, codec)
                         + centroids[spill_assign[start:start + sc].long()])
            with full_fp32():
                dist = pairwise_tile(xq, chunk, metric, metric_arg)
            score = dist if sim else -dist
        valid = (member[spill_assign[start:start + sc].long()].T
                 & (spill_pos[start:start + sc] >= 0)[None, :])
        if mask is not None:
            valid = valid & mask[start:start + sc][None, :]
        score = torch.where(valid, score, _NEG_INF)
        ch_s, ch_i = exact_topk(score, min(k_pool, score.shape[1]))
        best_s, best_i = topk_ordered(torch.cat([best_s, ch_s], 1),
                                      torch.cat([best_i, start + ch_i], 1),
                                      k_pool)
    if use_int8:
        best_s, best_i = _spill_rerank(spill_payload, best_s, best_i, xq,
                                       sq_vmin, sq_scale, sq, k, metric)
    pos = spill_pos.long()[best_i.clamp(min=0)].to(torch.int32)
    return best_s, torch.where(torch.isneginf(best_s), -1, pos)


def ivf_sq_search(codes_sorted, vmin, scale, offsets, counts, centroids, xq,
                  mask, metric_arg, *, k, nprobe, metric, q_chunk, codec,
                  lmax):
    """IVF,SQ decode scan (``duckdb_faiss_ext_tpu/ops/ivf_scan.py::
    ivf_sq_search``, faiss IndexIVFScalarQuantizer): the probed code
    windows of the sorted buffer decoded to fp32 per query chunk and
    scored as ``ivf_search`` scores fp32 rows."""
    return ivf_search(
        codes_sorted, offsets, counts, centroids, xq, mask, metric_arg, k=k,
        nprobe=nprobe, metric=metric, q_chunk=q_chunk, lmax=lmax,
        decode=lambda c: sq_decode(c, vmin, scale, codec))


def ivf_pq_search(codes_sorted, codebooks, offsets, counts, centroids, xq,
                  mask, metric_arg, *, k, nprobe, metric, q_chunk, codec,
                  lmax):
    """IVF-PQ / IVF-RQ gather scan (``duckdb_faiss_ext_tpu/ops/ivf_scan.py::
    ivf_pq_search``, faiss IndexIVFPQ / IndexIVFResidualQuantizer,
    by_residual): the probed code windows of the sorted buffer decoded per
    query chunk, each row x = dec(code) + centroid of its probed list, and
    scored as ``ivf_search`` scores fp32 rows."""
    return ivf_search(
        codes_sorted, offsets, counts, centroids, xq, mask, metric_arg, k=k,
        nprobe=nprobe, metric=metric, q_chunk=q_chunk, lmax=lmax,
        decode=lambda c: codec_decode(c, codebooks, codec), by_residual=True)


def _spill_rerank(spill_payload, best_s, best_i, xq, vmin, scale, codec, k,
                  metric):
    """Decode the int8 pool's rows, rescore them in fp32 and keep the best
    k, in query blocks that keep the decoded tile near 2^25 values."""
    nq, d = xq.shape
    k_pool = best_s.shape[1]
    s2 = torch.empty_like(best_s)
    qb = max(1, (1 << 25) // max(k_pool * d, 1))
    for q0 in range(0, nq, qb):
        rows = best_i[q0:q0 + qb].clamp(min=0)
        n = rows.shape[0]
        xs = sq_decode(spill_payload[rows.reshape(-1)], vmin, scale,
                       codec).reshape(n, k_pool, d)
        s2[q0:q0 + qb] = spill_rerank_scores(xs, xq[q0:q0 + qb], metric)
    s2 = torch.where(torch.isneginf(best_s), _NEG_INF, s2)
    best, sel = exact_topk(s2, k)
    return best, best_i.gather(1, sel)


def ivf_sq_int8_search(codes, row_norm, row_sum, offsets, counts, centroids,
                       vmin, scale, xq, mask, metric_arg, *, k, k_scan,
                       nprobe, metric, q_chunk, codec, lmax):
    """Int8 IVF scan over the sorted SQ codes (``duckdb_faiss_ext_tpu/ops/
    ivf_scan.py::ivf_sq_int8_search``): per query chunk, the probed code
    windows are scored by exact int8 digit dots (codes shifted by
    SQ_INT8_SHIFT), the top ``k_scan`` decoded and rescored in fp32 (L2 in
    difference form), then the best k.  ``row_norm`` / ``row_sum`` are
    the sorted rows' Σ(scale·c)² and Σc.  Returns the ``ivf_search``
    convention (sorted-row positions)."""
    nq, d = xq.shape
    w = codes.shape[1]
    nprobe = min(nprobe, centroids.shape[0])
    probe_ids = coarse_topk(xq, centroids, nprobe, metric, metric_arg)
    shift = SQ_INT8_SHIFT[codec]
    q = query_digits(xq, vmin, scale, metric, codec, w, shift)
    dev = xq.device
    best_s = torch.full((nq, k), _NEG_INF, dtype=torch.float32, device=dev)
    best_p = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for q0 in range(0, nq, q_chunk):
        xq_c = xq[q0:q0 + q_chunk]
        qc = xq_c.shape[0]
        packed, pos, valid = slice_probed_lists(
            codes, offsets, counts, probe_ids[q0:q0 + q_chunk], lmax=lmax)
        ncand = packed.shape[1] * packed.shape[2]
        pos = pos.reshape(qc, ncand)
        valid = valid.reshape(qc, ncand)
        dots = digit_dots(packed.reshape(qc, ncand, w),
                          q.digits[q0:q0 + q_chunk], codec, shift)
        score = int8_scores(dots[:, 0], dots[:, 1],
                            q.scalars[q0:q0 + q_chunk, None, :],
                            row_sum[pos], row_norm[pos], metric)
        if mask is not None:
            valid = valid & mask[pos]
        score = torch.where(valid, score, _NEG_INF)
        s, sel = exact_topk(score, min(k_scan, ncand))
        csel = pos.gather(1, sel)
        xs = sq_decode(codes[csel.reshape(-1)], vmin, scale, codec) \
            .reshape(qc, -1, d)
        s2 = torch.where(torch.isneginf(s), _NEG_INF,
                         exact_rows_scores(xs, xq_c, metric))
        s, sel2 = exact_topk(s2, k)
        p = csel.gather(1, sel2).to(torch.int32)
        best_s[q0:q0 + qc, :s.shape[1]] = s
        best_p[q0:q0 + qc, :s.shape[1]] = torch.where(torch.isneginf(s), -1, p)
    return best_s, best_p


def merge_topk(scores_a, pos_a, scores_b, pos_b, k: int):
    """Best k of two max-oriented candidate sets; on equal scores the first
    set's entries come first (``lax.top_k`` over the concatenation)."""
    cat_s = torch.cat([scores_a, scores_b], 1)
    cat_p = torch.cat([pos_a, pos_b], 1)
    best, sel = exact_topk(cat_s, k)
    return best, cat_p.gather(1, sel)
