"""IVF search dispatch.

The counterpart of ``duckdb_faiss_ext_tpu/models/ivf_serve.py`` (``search``,
``search_dispatch``, ``_dispatch_inner``, ``_coarse_topk``) for Flat
storage: parameter resolution (nprobe + ``quantiser.``-scoped recursion,
src/faiss_extension.cpp:675-689) and path selection.

* With a layout plan (L2 / inner product whose padded layout fits,
  models/ivf_layout.py): coarse top-nprobe, then the per-query list scan
  (K6, ops/ivf_list_scan.py) or, for large batches over long lists, the
  pair-tile scan (K7, ops/ivf_pairs.py), chosen by the JAX package's
  static rule (``pairs_wanted``); the spill region of a capped layout is
  scanned densely and merged.  A batch whose scan temporaries would pass
  ``SCAN_BLOCK_BYTES`` runs in query blocks.  On a
  CUDA index these are the hand-written kernels; on a CPU index their
  plain versions.
* Without one (elementwise metrics, or a layout over budget): the
  sorted+gather scan (ops/ivf_scan.py), as in the JAX package.

Not ported here: range search, the sharded placement, SOAR.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.flat_search import finalize_scores
from ..ops.ivf_list_scan import ivf_list_search
from ..ops.ivf_pairs import ivf_pairs_search
from ..ops.ivf_scan import (choose_q_chunk, coarse_topk, ivf_search,
                            ivf_spill_scan, merge_topk)
from ..params import EMPTY
from ..utils.config import config, next_pow2, pad_rows
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
    #: nprobe x (lmax + d) fp32 per query: K6's (nq, nprobe, lmax) score
    #: block, or K7's raw tiles and the queries copied into them.  The
    #: top-k's int64 order keys take several times the score block on
    #: top, so 1 GiB keeps a block's temporaries near 10 GiB beside a
    #: layout of up to LAYOUT_BUDGET_BYTES.  A larger batch is split into
    #: power-of-two query blocks.
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

    def query_block(self, nq_pad: int, nprobe: int, lmax: int) -> int:
        """Rows of the padded batch that one list scan takes: nq_pad, or
        the largest power of two below it whose temporaries fit
        SCAN_BLOCK_BYTES."""
        per_query = 4 * nprobe * (lmax + self.d)
        blk = nq_pad
        while blk > 1 and blk * per_query > self.SCAN_BLOCK_BYTES:
            blk //= 2
        return blk

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

        if self._layout_plan() is not None:
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
        scores, pos = ivf_search(
            sl.xb, offs, cnts, sl.centroids, xq_pad, mask, self.metric_arg,
            k=k_eff, nprobe=nprobe_eff, metric=metric,
            q_chunk=choose_q_chunk(nq_pad, nprobe_eff * sl.lmax, self.d),
            lmax=sl.lmax)
        dist, pos = finalize_scores(scores, pos, metric)
        return dist, pos, nq, k_eff, _labels_through(
            self._sorted_ids(sl.order))

    def _scan_lists(self, lay, xq, nprobe, k_kernel, k_eff, mask, sp_mask):
        """One query block through the padded layout: coarse top-nprobe,
        the list scan (K6, or K7 by pairs_wanted), and the spill region
        merged in.  Returns max-oriented (scores, positions) (nq, k_eff)."""
        metric = self.metric.name
        lmax = lay.payload.shape[1]
        probe_ids = coarse_topk(xq, lay.centroids, nprobe, metric,
                                self.metric_arg)
        if self.pairs_wanted(xq.shape[0], lmax):
            self._last_scan_path = "pairs-flat"
            k_scan = min(nprobe * lmax, max(4 * k_kernel, k_kernel + 32))
            scores, pos = ivf_pairs_search(
                lay.payload, lay.counts, lay.row_pos, probe_ids, xq, mask,
                k=k_kernel, k_scan=k_scan, metric=metric)
        else:
            self._last_scan_path = "per-query"
            scores, pos = ivf_list_search(
                lay.payload, lay.counts, lay.row_pos, probe_ids, xq, mask,
                k=k_kernel, metric=metric)
        spill = self._spill
        if spill is not None:
            sp_scores, sp_pos = ivf_spill_scan(
                spill.payload, spill.assign, spill.pos, probe_ids, xq,
                sp_mask, self.metric_arg, k=k_eff, metric=metric,
                nlist=self.nlist)
            scores, pos = merge_topk(scores, pos, sp_scores, sp_pos, k_eff)
        return scores, pos
