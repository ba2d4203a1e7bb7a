"""IVF search dispatch.

The counterpart of ``duckdb_faiss_ext_tpu/models/ivf_serve.py`` (``search``,
``search_dispatch``, ``_dispatch_inner``, ``_coarse_topk``, ``_sq_kscan``)
for Flat, SQ8 / SQ4 / SQ6 / SQfp16 / SQbf16 and PQ / RQ storage:
parameter resolution
(nprobe + ``quantiser.``-scoped recursion, src/faiss_extension.cpp:675-689)
and path selection.

* With a layout plan (L2 / inner product whose padded layout fits,
  models/ivf_layout.py; for SQ only while the int8 path is active):
  coarse top-nprobe, then the per-query list scan or, for large batches
  over long lists, the pair-tile scan, chosen by the JAX package's static
  rule (``pairs_wanted``): K6 / K7 (ops/ivf_list_scan.py,
  ops/ivf_pairs.py; each a fused search that ends in its top-k, K7's
  rescoring its k_scan pool in fp32) for Flat, K2 / K3 (ops/ivf_sq_scan.py,
  ops/ivf_sq_pairs.py) for SQ, whose top ``_sq_kscan`` int8 candidates are
  rescored in fp32; K8 (ops/ivf_pq_scan.py) for PQ / RQ, which has no
  pair-tile path (nor had it in the JAX package) and returns the top-k
  itself; a PQ / RQ search with k above K8's limit (``MAX_K``, 1024)
  takes the sorted+gather path below, as Flat takes its plain scan above
  K1's.  Under ``config.pairs_impl = "mega"`` the pair tiles go through
  the pipelined K10 / K9 (ops/ivf_pairs_mega.py, ops/ivf_sq_pairs_mega.py)
  in place of K7 / K3, with the same results.  A device-resident index
  (models/ivf_device.py) always has a layout plan, and its SQ lists take
  the int8 kernels in both precision modes.  The spill region of a
  capped layout is scanned densely and merged: for sq8 / sq4 at d ≥ 16 and
  k ≤ 128 by K5 (ops/sq_spill.py), otherwise by the plain spill scan
  (ops/ivf_scan.py; sq6 and PQ / RQ always).  A
  batch whose scan temporaries would pass ``SCAN_BLOCK_BYTES`` runs in
  query blocks.  On a CUDA index these are the hand-written kernels; on a
  CPU index their plain versions.
* Without one (elementwise metrics, SQ in parity mode, the float SQ
  codecs, or a layout over budget): the sorted+gather scan
  (ops/ivf_scan.py), as in the JAX package; for SQ the fp32 decode scan,
  or for SQ8 / SQ4 / SQ6 the int8 gather scan when the int8 path is active
  and d ≥ 16; for PQ / RQ the residual decode scan.  The float codecs
  never reach the int8 kernels (K2 / K3 / K5 / K9).

The stages run one after another.  The JAX package's single-jit
``_fused_sq_pairs_serve`` joined the same stages into one XLA program
against the relay's dispatch gaps (its results are identical to the staged
path's); its spill gates ``spill_chunk_ok`` (a Mosaic block rule) and
``spill_pallas_min`` (a crossover measured on the TPU) are not ported.

With SOAR (``soar_lambda`` > 0) every row is stored twice, so
``search_dispatch`` fetches 2k candidates and a host post-process drops
same-source duplicates (``models.base.dedup_by_key`` keyed on the source
row, so genuinely repeated user labels stay) before padding back to k.

``range_search`` scans the probed lists of the sorted+gather layout on the
device (ops/range.py::ivf_range_scan; faiss::IndexIVF::range_search's
contract, exact within the probed lists), decoding SQ / PQ / RQ codes
window by window.  The JAX package decoded the whole sorted corpus on
every call (12.9 GB at 2M x 1536); the port decodes only the probed
lists, with the same result.  SOAR's duplicates are dropped per (query,
label), keeping the best.  A device-resident index has no sorted layout
and refuses range search with the JAX package's text.

Under a placement (faiss_to_device, models/ivf_sharded.py) the lists are
cut into one sub-layout a shard and every shard runs the same list search
on its own lists (``_list_search``; the plain decode scan where the
single-device index would take the sorted+gather path), then the shards
merge.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..ops.flat_search import SIMILARITY_METRICS, finalize_scores
from ..ops.ivf_list_scan import ivf_list_search
from ..ops.ivf_pairs import ivf_pairs_search
from ..ops.ivf_pq_scan import MAX_K as PQ_MAX_K
from ..ops.ivf_pq_scan import ivf_pq_list_search
from ..ops.ivf_scan import (choose_q_chunk, coarse_topk, ivf_pq_search,
                            ivf_search, ivf_spill_scan, ivf_sq_int8_search,
                            ivf_sq_search, merge_topk)
from ..ops.ivf_sq_pairs import ivf_sq_pairs_search
from ..ops.ivf_sq_scan import ivf_sq_list_search
from ..ops.sq import SQ_LEVELS
from ..ops.sq_spill import CODECS as SPILL_KERNEL_CODECS
from ..ops.sq_spill import sq_spill_search
from ..params import EMPTY
from ..utils.config import config, next_pow2, pad_rows, sq_int8_active
from ..utils.transfer import upload_queries
from .base import SearchResult, as_matrix, dedup_by_key


def _labels_through(table: np.ndarray):
    """Positions → entries of ``table`` (-1 stays -1)."""
    def to_labels(pos: np.ndarray) -> np.ndarray:
        return np.where(pos >= 0, table[np.clip(pos, 0, None)]
                        if table.size else pos, -1)
    return to_labels


class IVFServe:
    """Search methods of ``models.ivf.IVFIndex``."""

    #: batch size from which the pair-tile scan may take over
    PAIRS_MIN_BATCH = 256
    #: minimum lmax*d for the pair-tile scan (the JAX package's static
    #: rule); 0 forces the pair tiles for every batch of PAIRS_MIN_BATCH
    #: or more (tests at tiny shapes)
    PAIRS_MIN_WORK = 1 << 19
    #: device bytes a query block of the list scans may take, counted as
    #: nprobe x (lmax + d) fp32 per query: the raw routes' temporaries (K6's
    #: (nq, nprobe, lmax) score block, or K7's raw tiles and the queries
    #: copied into them, whose top-k's int64 order keys take several times
    #: the block on top), so 1 GiB keeps a block's temporaries near 10 GiB
    #: beside a layout of up to LAYOUT_BUDGET_BYTES.  The fused searches
    #: below the raw routes' limits allocate far less: K6 its (nq, splits,
    #: k) candidates, K7 / K10 nprobe x ceil(lmax / 512) lists of k_scan
    #: (score, index) pairs a query (37 MiB at IVF1024 b1024, nprobe 16,
    #: lmax 3584, k_scan 42).  A larger batch is split into power-of-two
    #: query blocks.
    SCAN_BLOCK_BYTES = 1 << 30

    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        return self._finish_dispatch(
            self.search_dispatch(xq, k, params, selector), xq, k)

    def pairs_wanted(self, nq: int, lmax: int) -> bool:
        """Whether a (padded) batch of nq queries over lists padded to lmax
        takes the pair tiles (K7) rather than the per-query scan (K6): the
        JAX package's static rule, which its gate falls back to away from
        measured rows (ops/pairs_gate.py there; none are measured on this
        card yet)."""
        return (nq >= self.PAIRS_MIN_BATCH
                and lmax * self.d >= self.PAIRS_MIN_WORK)

    def _sq_kscan(self, k: int, cap: int) -> int:
        """Rerank-pool width of the int8 SQ scans: true neighbours missed
        by the int8 ranking cannot be recovered by the exact rerank, so the
        coarser the codec the wider the pool (sq4 twice sq8 / sq6)."""
        f, add = (8, 96) if self.sq_type == "sq4" else (4, 32)
        return min(cap, max(f * k, k + add))

    def query_block(self, nq_pad: int, nprobe: int, lmax: int) -> int:
        """Rows of the padded batch that one list scan takes: nq_pad, or
        the largest power of two below it whose temporaries fit
        SCAN_BLOCK_BYTES."""
        per_query = 4 * nprobe * (lmax + self.d)
        blk = nq_pad
        while blk > 1 and blk * per_query > self.SCAN_BLOCK_BYTES:
            blk //= 2
        return blk

    def _layout_serves(self, k: int) -> bool:
        """Whether a search for k goes through the padded layout: there is
        a layout plan, and for PQ / RQ k is within K8's limit (PQ_MAX_K);
        above it the sorted+gather scan serves."""
        return (self._layout_plan() is not None
                and (self.pq_m is None or k <= PQ_MAX_K))

    def _mapper(self, order=None):
        """Positions → labels through the ids (storage order, or the sorted
        layout's ``order``); with SOAR it carries ``src_of``, positions →
        logical source rows, the duplicates' key."""
        to_labels = _labels_through(
            self._ids if order is None else self._sorted_ids(order))
        if self._srcrow is not None:
            to_labels.src_of = _labels_through(
                self._srcrow if order is None else self._srcrow[order])
        return to_labels

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """Device dispatch without the host fetch: (dist, pos, nq, k_eff,
        positions→labels[, post]) or None when no device work applies
        (empty queries, k ≤ 0, empty index).  With SOAR: 2k candidates and
        the duplicate-dropping ``post``."""
        k = int(k)
        if self.soar_lambda <= 0.0 or k <= 0:
            return self._dispatch_inner(xq, k, params, selector)
        disp = self._dispatch_inner(xq, 2 * k, params, selector)
        if disp is None:
            return None
        dist, pos, nq, _, to_labels = disp
        sentinel = (float("-inf") if self.metric.name in SIMILARITY_METRICS
                    else float("inf"))
        src_of = getattr(to_labels, "src_of", None)

        def post(d, labels, pos_host):
            keys = src_of(pos_host) if src_of is not None else labels
            return dedup_by_key(d, labels, keys, k, sentinel)

        return dist, pos, nq, k, to_labels, post

    def _dispatch_inner(self, xq, k, params=EMPTY, selector=None):
        self._require_trained()
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        k = int(k)
        if nq == 0 or k <= 0 or self.ntotal == 0:
            return None
        # SearchParametersIVF: nprobe plus quantiser.-scoped recursion.  The
        # coarse assignment is one exact distance tile, so quantiser.*
        # params parse but cannot change results.
        nprobe = params.get_int("nprobe", self.nprobe_default)
        params.scoped("quantiser.")
        nprobe_eff = max(1, min(int(nprobe), self.nlist))
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        xq_pad = upload_queries(pad_rows(xq, nq_pad), self.device)
        metric = self.metric.name

        if self._shard_mesh is not None:
            # Placed over a mesh (faiss_to_device): lists partitioned over
            # the shards, the k·S merge.
            return self._search_sharded(xq_pad, nq, k, nprobe_eff, selector)
        if self._layout_serves(k):
            lay = self._build_device_layout()
            lmax = lay.payload.shape[1]
            spill = self._spill
            # Spill rows are candidates beyond the capped layout: k_eff
            # counts them, or k > nprobe·lmax would truncate to the slots.
            k_kernel = min(k, nprobe_eff * lmax)
            k_eff = min(k, nprobe_eff * lmax + (spill.n if spill else 0))
            masks = ((self._layout_mask(selector),
                      self._spill_mask(selector) if spill else None)
                     if selector is not None else (None, None))
            blk = self.query_block(nq_pad, nprobe_eff, lmax)
            parts = [self._scan_lists(lay, xq_pad[q0:q0 + blk], nprobe_eff,
                                      k_kernel, k_eff, *masks)
                     for q0 in range(0, nq_pad, blk)]
            scores, pos = (parts[0] if len(parts) == 1 else
                           (torch.cat(t) for t in zip(*parts)))
            dist, pos = finalize_scores(scores, pos, metric)
            return dist, pos, nq, k_eff, self._mapper()

        self._last_scan_path = "gather"
        sl = self._build_device()
        k_eff = min(k, nprobe_eff * sl.lmax)
        offs, cnts = self._sorted_list_meta()
        mask = (self._selector_mask(selector, sl.order)
                if selector is not None else None)
        q_chunk = choose_q_chunk(nq_pad, nprobe_eff * sl.lmax, self.d)
        if self.sq_type in SQ_LEVELS and sq_int8_active() and self.d >= 16:
            # (tiny-d margins sit at the int8 noise floor: decode below 16)
            self._last_scan_path = "gather-int8"
            vmin, scale = self._sq_ranges()
            rn, rs = self._sorted_sq_extras()
            scores, pos = ivf_sq_int8_search(
                sl.xb, rn, rs, offs, cnts, sl.centroids, vmin, scale, xq_pad,
                mask, self.metric_arg, k=k_eff,
                k_scan=self._sq_kscan(k_eff, nprobe_eff * sl.lmax),
                nprobe=nprobe_eff, metric=metric, q_chunk=q_chunk,
                codec=self.sq_type, lmax=sl.lmax)
        elif self.pq_m is not None:
            scores, pos = ivf_pq_search(
                sl.xb, sl.codebooks, offs, cnts, sl.centroids, xq_pad, mask,
                self.metric_arg, k=k_eff, nprobe=nprobe_eff, metric=metric,
                q_chunk=q_chunk, codec=self.pq_codec, lmax=sl.lmax)
        elif self.sq_type is not None:
            vmin, scale = self._sq_ranges()
            scores, pos = ivf_sq_search(
                sl.xb, vmin, scale, offs, cnts, sl.centroids, xq_pad, mask,
                self.metric_arg, k=k_eff, nprobe=nprobe_eff, metric=metric,
                q_chunk=q_chunk, codec=self.sq_type, lmax=sl.lmax)
        else:
            scores, pos = ivf_search(
                sl.xb, offs, cnts, sl.centroids, xq_pad, mask,
                self.metric_arg, k=k_eff, nprobe=nprobe_eff, metric=metric,
                q_chunk=q_chunk, lmax=sl.lmax)
        dist, pos = finalize_scores(scores, pos, metric)
        return dist, pos, nq, k_eff, self._mapper(sl.order)

    def range_search(self, xq, radius, params=EMPTY, selector=None):
        """All rows within ``radius`` in the probed lists (nprobe as in
        search), as a CSR ``RangeSearchResult`` of labels."""
        from ..ops.pq import codec_decode
        from ..ops.range import (dedup_range_labels, empty_range_result,
                                 ivf_range_scan)
        from ..ops.sq import sq_decode

        self._require_trained()
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        if nq == 0 or self.ntotal == 0:
            return empty_range_result(nq)
        if self._dr is not None:
            # The JAX package's text (its sorted layout refuses such an
            # index the same way).
            raise errors.InvalidInputError(
                "this device-resident index serves only through the "
                "list-scan kernel (range search and nprobe beyond the "
                "SMEM probe budget need a host-path index)")
        nprobe = params.get_int("nprobe", self.nprobe_default)
        nprobe_eff = max(1, min(int(nprobe), self.nlist))
        metric = self.metric.name
        sl = self._build_device()
        offs, cnts = self._sorted_list_meta()
        xq_dev = upload_queries(xq, self.device)
        probe_ids = coarse_topk(xq_dev, sl.centroids, nprobe_eff, metric,
                                self.metric_arg)
        labels_sorted = self._sorted_ids(sl.order)
        decode = centroids = None
        if self.pq_m is not None:
            def decode(c):
                return codec_decode(c, sl.codebooks, self.pq_codec)
            centroids = sl.centroids
        elif self.sq_type is not None:
            vmin, scale = self._sq_ranges()

            def decode(c):
                return sq_decode(c, vmin, scale, self.sq_type)
        res = ivf_range_scan(
            sl.xb, offs, cnts, probe_ids, xq_dev, nq, float(radius), metric,
            self.metric_arg, lmax=sl.lmax, labels_sorted=labels_sorted,
            passing=(selector.contains(labels_sorted)
                     if selector is not None else None),
            decode=decode, centroids=centroids)
        if self.soar_lambda > 0.0:
            res = dedup_range_labels(res, metric in SIMILARITY_METRICS)
        return res

    def _scan_lists(self, lay, xq, nprobe, k_kernel, k_eff, mask, sp_mask):
        """One query block through the padded layout: coarse top-nprobe,
        the list search (``_list_search``), and the spill region merged in.
        Returns max-oriented (scores, positions) (nq, k_eff)."""
        probe_ids = coarse_topk(xq, lay.centroids, nprobe, self.metric.name,
                                self.metric_arg)
        scores, pos = self._list_search(lay, xq, probe_ids, k_kernel, mask)
        if self._spill is None:
            return scores, pos
        sp_scores, sp_pos = self._spill_search(lay, xq, probe_ids, k_eff,
                                               sp_mask)
        return merge_topk(scores, pos, sp_scores, sp_pos, k_eff)

    def _list_search(self, lay, xq, probe_ids, k, mask):
        """The list kernels over a padded layout for given probes: K8 for
        PQ / RQ, K2 or K3 / K9 (by pairs_wanted) with the exact rerank for
        SQ, K6 or K7 / K10 for Flat.  Returns max-oriented (scores,
        storage positions) (nq, k)."""
        metric = self.metric.name
        lmax = lay.payload.shape[1]
        if self.sq_type is not None:
            nprobe = probe_ids.shape[1]
            vmin, scale = self._sq_ranges(lay.payload.device)
            args = (lay.payload, lay.rn, lay.rs, lay.counts, lay.row_pos,
                    probe_ids, xq, mask, vmin, scale)
            search = dict(k=k, k_scan=self._sq_kscan(k, nprobe * lmax),
                          metric=metric, codec=self.sq_type)
            if self.pairs_wanted(xq.shape[0], lmax):
                mega = config.pairs_impl == "mega"
                self._last_scan_path = (("pairs-mega-" if mega else "pairs-")
                                        + self.sq_type)
                return ivf_sq_pairs_search(*args, **search, mega=mega)
            self._last_scan_path = "per-query"
            return ivf_sq_list_search(*args, **search)
        if self.pq_m is not None:
            self._last_scan_path = "per-query"
            return ivf_pq_list_search(
                lay.payload, lay.counts, lay.row_pos, lay.codebooks,
                lay.centroids, probe_ids, xq, mask, k=k, metric=metric,
                codec=self.pq_codec, row_terms=lay.rt)
        if self.pairs_wanted(xq.shape[0], lmax):
            mega = config.pairs_impl == "mega"
            self._last_scan_path = "pairs-mega-flat" if mega else "pairs-flat"
            k_scan = min(probe_ids.shape[1] * lmax, max(4 * k, k + 32))
            return ivf_pairs_search(
                lay.payload, lay.counts, lay.row_pos, probe_ids, xq, mask,
                k=k, k_scan=k_scan, metric=metric, mega=mega)
        self._last_scan_path = "per-query"
        return ivf_list_search(lay.payload, lay.counts, lay.row_pos,
                               probe_ids, xq, mask, k=k, metric=metric)

    def _spill_search(self, lay, xq, probe_ids, k_eff, sp_mask):
        """The spill region's best rows for the probes: K5 for sq8 / sq4 at
        d ≥ 16 and k ≤ 128 on the int8 path, else the plain spill scan (SQ
        rows decoded or int8-scored, PQ / RQ codes decoded with their
        list's centroid).  Returns max-oriented (scores, positions)."""
        metric, codec = self.metric.name, self.sq_type
        sp = self._spill
        if codec is None:
            extra = dict(codec=self.pq_codec, codebooks=lay.codebooks,
                         centroids=lay.centroids) if self.pq_m else {}
            return ivf_spill_scan(
                sp.payload, sp.assign, sp.pos, probe_ids, xq, sp_mask,
                self.metric_arg, k=k_eff, metric=metric, nlist=self.nlist,
                **extra)
        int8 = sq_int8_active() or self._dr is not None
        vmin, scale = self._sq_ranges()
        k_sp = min(k_eff, sp.payload.shape[0])
        if (codec in SPILL_KERNEL_CODECS and int8 and self.d >= 16
                and k_eff <= 128 and sp.n > 0):
            return sq_spill_search(
                sp.payload, sp.assign, sp.pos, sp.rs, sp.rn, sp.n, probe_ids,
                xq, sp_mask, vmin, scale, k=k_sp, metric=metric, codec=codec,
                offsets=sp.offsets)
        return ivf_spill_scan(
            sp.payload, sp.assign, sp.pos, probe_ids, xq, sp_mask,
            self.metric_arg, k=k_sp, metric=metric, nlist=self.nlist,
            sq=codec, sq_vmin=vmin, sq_scale=scale, spill_rn=sp.rn,
            spill_rs=sp.rs, int8_dot=self.d >= 16 and int8)
