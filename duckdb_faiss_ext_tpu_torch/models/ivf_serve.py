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

Not ported here: range search, the sharded placement, SOAR.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.flat_search import finalize_scores
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
from .base import SearchResult, as_matrix


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

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """Device dispatch without the host fetch: (dist, pos, nq, k_eff,
        positions→labels) or None when no device work applies (empty
        queries, k ≤ 0, empty index)."""
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
        xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(self.device)
        metric = self.metric.name

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
            return dist, pos, nq, k_eff, _labels_through(self._ids)

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
        return dist, pos, nq, k_eff, _labels_through(
            self._sorted_ids(sl.order))

    def _scan_lists(self, lay, xq, nprobe, k_kernel, k_eff, mask, sp_mask):
        """One query block through the padded layout: coarse top-nprobe,
        the list scan (K6 / K2, or K7 / K3 by pairs_wanted; K8 for PQ / RQ),
        and the spill region merged in.  Returns max-oriented (scores,
        positions) (nq, k_eff)."""
        metric = self.metric.name
        lmax = lay.payload.shape[1]
        probe_ids = coarse_topk(xq, lay.centroids, nprobe, metric,
                                self.metric_arg)
        if self.sq_type is not None:
            return self._scan_sq_lists(lay, xq, probe_ids, k_kernel, k_eff,
                                       mask, sp_mask)
        if self.pq_m is not None:
            self._last_scan_path = "per-query"
            scores, pos = ivf_pq_list_search(
                lay.payload, lay.counts, lay.row_pos, lay.codebooks,
                lay.centroids, probe_ids, xq, mask, k=k_kernel,
                metric=metric, codec=self.pq_codec, row_terms=lay.rt)
        elif self.pairs_wanted(xq.shape[0], lmax):
            mega = config.pairs_impl == "mega"
            self._last_scan_path = "pairs-mega-flat" if mega else "pairs-flat"
            k_scan = min(nprobe * lmax, max(4 * k_kernel, k_kernel + 32))
            scores, pos = ivf_pairs_search(
                lay.payload, lay.counts, lay.row_pos, probe_ids, xq, mask,
                k=k_kernel, k_scan=k_scan, metric=metric, mega=mega)
        else:
            self._last_scan_path = "per-query"
            scores, pos = ivf_list_search(
                lay.payload, lay.counts, lay.row_pos, probe_ids, xq, mask,
                k=k_kernel, metric=metric)
        spill = self._spill
        if spill is not None:
            codec = dict(codec=self.pq_codec, codebooks=lay.codebooks,
                         centroids=lay.centroids) if self.pq_m else {}
            sp_scores, sp_pos = ivf_spill_scan(
                spill.payload, spill.assign, spill.pos, probe_ids, xq,
                sp_mask, self.metric_arg, k=k_eff, metric=metric,
                nlist=self.nlist, **codec)
            scores, pos = merge_topk(scores, pos, sp_scores, sp_pos, k_eff)
        return scores, pos

    def _scan_sq_lists(self, lay, xq, probe_ids, k_kernel, k_eff, mask,
                       sp_mask):
        """``_scan_lists`` for SQ codes: K2, K3 or K9 and the exact rerank,
        then the spill region through K5 or the plain SQ spill scan."""
        metric, codec = self.metric.name, self.sq_type
        int8 = sq_int8_active() or self._dr is not None
        nprobe = probe_ids.shape[1]
        lmax = lay.payload.shape[1]
        vmin, scale = self._sq_ranges()
        args = (lay.payload, lay.rn, lay.rs, lay.counts, lay.row_pos,
                probe_ids, xq, mask, vmin, scale)
        search = dict(k=k_kernel, k_scan=self._sq_kscan(k_kernel,
                                                        nprobe * lmax),
                      metric=metric, codec=codec)
        if self.pairs_wanted(xq.shape[0], lmax):
            mega = config.pairs_impl == "mega"
            self._last_scan_path = ("pairs-mega-" if mega else "pairs-") + codec
            scores, pos = ivf_sq_pairs_search(*args, **search, mega=mega)
        else:
            self._last_scan_path = "per-query"
            scores, pos = ivf_sq_list_search(*args, **search)
        sp = self._spill
        if sp is None:
            return scores, pos
        k_sp = min(k_eff, sp.payload.shape[0])
        if (codec in SPILL_KERNEL_CODECS and int8 and self.d >= 16
                and k_eff <= 128 and sp.n > 0):
            sp_scores, sp_pos = sq_spill_search(
                sp.payload, sp.assign, sp.pos, sp.rs, sp.rn, sp.n, probe_ids,
                xq, sp_mask, vmin, scale, k=k_sp, metric=metric, codec=codec,
                offsets=sp.offsets)
        else:
            sp_scores, sp_pos = ivf_spill_scan(
                sp.payload, sp.assign, sp.pos, probe_ids, xq, sp_mask,
                self.metric_arg, k=k_sp, metric=metric, nlist=self.nlist,
                sq=codec, sq_vmin=vmin, sq_scale=scale, spill_rn=sp.rn,
                spill_rs=sp.rs, int8_dot=self.d >= 16 and int8)
        return merge_topk(scores, pos, sp_scores, sp_pos, k_eff)
