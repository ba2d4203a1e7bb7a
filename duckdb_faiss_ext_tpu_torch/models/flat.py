"""Flat (exact brute-force) index over a padded device buffer.

Vectors live in a host mirror (numpy, the source of truth for save and
for re-uploads) and in a buffer on ``config.device`` padded to a capacity
bucket (powers of two up to 1M rows, then 1M-row steps).  The buffer is
re-uploaded only when the bucket grows; adds that fit are copied into it
in place.  On the card, L2 and inner product search through the
hand-written fused distance + top-k kernel (ops/flat_topk.py); the seven
elementwise metrics and k > 1024 take the plain scan (ops/flat_search.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import Metric
from ..ops import flat_topk
from ..ops.flat_search import SIMILARITY_METRICS, flat_search, topk_ordered
from ..ops.selectors import Selector
from ..utils.config import (config, next_capacity, next_pow2, pad_rows,
                            resolve_device)
from .base import Index, SearchResult, as_matrix


class FlatIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0):
        super().__init__(d, metric, metric_arg)
        #: where the corpus buffer lives and searches run; raises here when
        #: CUDA is asked for without a card.
        self.device = resolve_device()
        self._xb = np.empty((0, d), dtype=np.float32)
        self._version = 0
        self._device_xb: torch.Tensor | None = None  # (cap, d)
        self._mask_cache: dict = {}

    # --- storage ---------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self._xb.shape[0]

    def add(self, x) -> None:
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
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
            self._device_xb[start:self.ntotal].copy_(torch.from_numpy(x))
        else:
            self._device_xb = None
        self._mask_cache.clear()

    def _capacity(self) -> int:
        return max(config.min_capacity, next_capacity(max(self.ntotal, 1)))

    def device_vectors(self) -> torch.Tensor:
        """Padded (cap, d) buffer on the index's device; uploaded only when
        the capacity bucket grew or the data was reloaded."""
        cap = self._capacity()
        if self._device_xb is None or self._device_xb.shape[0] < cap:
            buf = torch.zeros((cap, self.d), dtype=torch.float32,
                              device=self.device)
            buf[:self.ntotal].copy_(torch.from_numpy(self._xb))
            self._device_xb = buf
        return self._device_xb

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
        xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(self.device)
        mask = self._selector_mask(selector) if selector is not None else None
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
            dist, pos = _rerank(self.device_vectors(), pos, xq_pad, k_eff,
                                self.metric.name)
        return dist, pos, nq, k_eff

    def _dispatch_search(self, xq_pad, k_eff, mask):
        """L2 / inner product with k ≤ 1024 go to the fused kernel (on a CPU
        tensor its plain version); everything else to the plain scan."""
        xb = self.device_vectors()
        if flat_topk.supports(self.metric.name, k_eff, self.d):
            return flat_topk.kernel_flat_search(
                xb, self.ntotal, xq_pad, k_eff, self.metric.name, mask=mask)
        return flat_search(xb, self.ntotal, xq_pad, k_eff, self.metric.name,
                           self.metric_arg, mask=mask)

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"xb": self._xb}

    def load_state(self, state: dict) -> None:
        self._xb = np.asarray(state["xb"], dtype=np.float32).reshape(-1, self.d)
        self._version += 1
        self._device_xb = None
        self._mask_cache.clear()


def _rerank(xb, pos, xq, k, metric):
    """Exact fp32 re-score of the candidate rows ``pos`` (-1 = missing
    stays missing); returns best-first (distances, positions) of width k."""
    safe = pos.clamp(min=0).long()
    xc = xb[safe]                                        # (nq, ks, d)
    if metric == "INNER_PRODUCT":
        s = (xc * xq[:, None, :]).sum(-1)  # elementwise: no TF32 matmul
    else:
        diff = xc - xq[:, None, :]
        s = -(diff * diff).sum(-1)
    s = torch.where(pos >= 0, s, float("-inf"))
    best, pos = topk_ordered(s, pos, k)
    missing = torch.isneginf(best)
    sim = metric in SIMILARITY_METRICS
    dist = best if sim else -best
    dist = torch.where(missing, float("-inf") if sim else float("inf"), dist)
    return dist, torch.where(missing, -1, pos)
