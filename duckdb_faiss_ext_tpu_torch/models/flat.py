"""Flat (exact brute-force) index over a padded device buffer.

Vectors live in a host mirror (numpy, the source of truth for save and
for re-uploads) and in a buffer on ``config.device`` padded to a capacity
bucket (powers of two up to 1M rows, then 1M-row steps).  The buffer is
re-uploaded only when the bucket grows; adds that fit are copied into it
in place.  On the card, L2 and inner product search through the
hand-written fused distance + top-k kernel (ops/flat_topk.py); the seven
elementwise metrics and k > 1024 take the plain scan (ops/flat_search.py).

With ``storage="pm1_i8"`` (the code corpus of LSHIndex) the rows are ±1
sign codes stored int8 and queries are cast the same way; their dots are
exact int32 products (``ops.flat_search.pm1_search``: ``torch._int_mm``
on the card, an int32 matmul on the CPU), never K1, as the JAX package
kept int8 codes out of its Pallas kernel.

``set_placement`` (faiss_to_device, parallel/placement.py) puts the buffer
on a mesh as S row blocks (``RowBlocks``), the capacity rounded to a
multiple of the mesh's device count; a search then runs K1 (or the int8
sign-code scan) on every block and merges the shards' top-k
(parallel/sharded.py).  The placement is sticky: adds write into the
blocks, and a grown buffer is placed again the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import Metric
from ..ops import flat_topk
from ..ops.flat_search import finalize_scores, flat_search, pm1_search
from ..ops.selectors import Selector
from ..parallel.sharded import sharded_flat_search, sharded_rows_search
from ..utils.config import (config, next_capacity, next_pow2, pad_rows,
                            resolve_device)
from ..utils.transfer import upload_queries
from .base import Index, SearchResult, as_matrix, placement_capacity


class FlatIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 storage: str = "f32"):
        super().__init__(d, metric, metric_arg)
        #: where the corpus buffer lives and searches run; raises here when
        #: CUDA is asked for without a card.
        self.device = resolve_device()
        #: "f32", or "pm1_i8": ±1 sign codes stored int8 (only inner
        #: product ordering is meaningful for them)
        self.storage = storage
        self._dtype = np.int8 if storage == "pm1_i8" else np.float32
        self._xb = np.empty((0, d), dtype=self._dtype)
        self._version = 0
        self._device_xb: torch.Tensor | None = None  # (cap, d)
        self._mask_cache: dict = {}
        #: sticky row placement set by faiss_to_device (RowPlacement), or
        #: None: the buffer on ``device``
        self._placement = None

    # --- storage ---------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self._xb.shape[0]

    def add(self, x) -> None:
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
        if self.storage == "pm1_i8":
            x = np.where(x > 0, 1, -1).astype(np.int8)
        start = self.ntotal
        self._xb = np.concatenate([self._xb, x], axis=0) if start else x
        self._version += 1
        # Streaming ingest stays O(batch): while the new rows fit the
        # current capacity bucket they are copied in place into the live
        # buffer (the JAX package re-bound a new immutable array here);
        # otherwise the buffer is dropped and re-uploaded at the grown
        # capacity on the next search.
        if (self._device_xb is not None
                and self.ntotal <= self._device_xb.shape[0]):
            if self._placement is not None:
                self._device_xb.write(start, x)
            else:
                self._device_xb[start:self.ntotal].copy_(torch.from_numpy(x))
        else:
            self._device_xb = None
        self._mask_cache.clear()

    def _capacity(self) -> int:
        return placement_capacity(
            max(config.min_capacity, next_capacity(max(self.ntotal, 1))),
            self._placement)

    def device_vectors(self):
        """Padded (cap, d) buffer on the index's device, or its RowBlocks
        under a placement; uploaded only when the capacity bucket grew or
        the data was reloaded."""
        cap = self._capacity()
        if self._device_xb is None or self._device_xb.shape[0] < cap:
            if self._placement is not None:
                self._device_xb = self._placement.place(
                    pad_rows(self._xb, cap), self.device)
                return self._device_xb
            buf = torch.zeros((cap, self.d), dtype=(
                torch.int8 if self.storage == "pm1_i8" else torch.float32),
                device=self.device)
            buf[:self.ntotal].copy_(torch.from_numpy(self._xb))
            self._device_xb = buf
        return self._device_xb

    def set_placement(self, placement) -> None:
        """Place the buffer over a mesh (a ``RowPlacement``; faiss_to_gpu
        analogue); None puts it back on ``device``."""
        self._placement = placement
        self._device_xb = None
        self._mask_cache.clear()

    # --- selector masks ---------------------------------------------------
    def _selector_mask(self, selector: Selector) -> torch.Tensor:
        key = (selector.cache_key(), self._version)
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        rows = selector.contains(self.row_labels())
        # Pad to the live buffer's capacity (it may exceed _capacity()
        # after in-place adds into a previously grown buffer).
        cap = self.device_vectors().shape[0]
        mask = torch.from_numpy(pad_rows(rows, cap, fill=False)).to(
            self.device)
        self._mask_cache = {key: mask}  # keep only the latest
        return mask

    # --- search ----------------------------------------------------------
    def search(self, xq, k, params=None, selector=None) -> SearchResult:
        return self._finish_dispatch(
            self.search_dispatch(xq, k, params, selector), xq, k)

    def search_dispatch(self, xq, k, params=None, selector=None):
        """Device dispatch without the host fetch: (dist (nq_pad, k_eff),
        pos, nq, k_eff) on the device, or None when no device work applies
        (empty queries, k≤0).  api.faiss_search_batched concatenates many
        dispatches and fetches once."""
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        k = int(k)
        if nq == 0 or k <= 0:
            return None
        cap = self._capacity()
        k_eff = min(k, cap)
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        xq_pad = upload_queries(pad_rows(xq, nq_pad), self.device)
        mask = self._selector_mask(selector) if selector is not None else None
        if self.storage == "pm1_i8":
            # Queries are sign codes too; the int8 dot is exact, so no
            # rerank ever applies.
            xq_i8 = torch.where(xq_pad > 0, 1, -1).to(torch.int8)
            xb = self.device_vectors()
            if self._placement is not None:
                scores, pos = sharded_rows_search(
                    xb, self.ntotal, xq_i8, k_eff,
                    lambda s, dev, blk, n, q, kk, m: pm1_search(blk, n, q, kk,
                                                                m), mask)
            else:
                scores, pos = pm1_search(xb, self.ntotal, xq_i8, k_eff, mask)
            dist, pos = finalize_scores(scores, pos, self.metric.name)
            return dist, pos, nq, k_eff
        # Opt-in exact rerank for fast mode ({"rerank": "true"}): scan a
        # wider top-k, then re-score those rows in fp32.  Queries go up as
        # fp32, so the rescore is exact.
        rerank = (
            params is not None
            and (params.get_str("rerank") or "").lower() in ("true", "1")
            and self.metric.name in flat_topk.METRICS
            and config.precision_mode != "parity"
        )
        k_scan = min(cap, max(2 * k_eff, k_eff + 16)) if rerank else k_eff
        dist, pos = self._dispatch_search(xq_pad, k_scan, mask)
        if rerank and k_scan > k_eff:
            from .refine import rerank as exact_rerank

            dist, pos = exact_rerank(self.device_vectors(), pos, xq_pad,
                                     k_eff, self.metric.name)
        return dist, pos, nq, k_eff

    def _dispatch_search(self, xq_pad, k_eff, mask):
        """L2 / inner product with k ≤ 1024 go to the fused kernel (on a CPU
        tensor its plain version); everything else to the plain scan.  Under
        a placement each shard's block does, and the shards merge."""
        xb = self.device_vectors()
        if self._placement is not None:
            return finalize_scores(*sharded_flat_search(
                xb, self.ntotal, xq_pad, k_eff, self.metric.name,
                self.metric_arg, mask), self.metric.name)
        if flat_topk.supports(self.metric.name, k_eff, self.d):
            return flat_topk.kernel_flat_search(
                xb, self.ntotal, xq_pad, k_eff, self.metric.name, mask=mask)
        return flat_search(xb, self.ntotal, xq_pad, k_eff, self.metric.name,
                           self.metric_arg, mask=mask)

    def vectors(self) -> np.ndarray:
        """Host view of the stored rows (n, d)."""
        return self._xb

    def reconstruct(self, key: int) -> np.ndarray:
        return self._xb[key]

    # --- range search -----------------------------------------------------
    def range_search(self, xq, radius, params=None, selector=None):
        """Dense tiles over the padded buffer, thresholded on the device
        (ops/range.py); int8 sign codes are scored as fp32."""
        from ..ops.range import dense_range_search

        return dense_range_search(self, xq, radius, selector,
                                  self.device_vectors(),
                                  lambda c: c.to(torch.float32))

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"xb": self._xb}

    def load_state(self, state: dict) -> None:
        self._xb = np.asarray(state["xb"], dtype=self._dtype).reshape(
            -1, self.d)
        self._version += 1
        self._device_xb = None
        self._mask_cache.clear()

