"""Refine-Flat wrapper: exact re-ranking of a compressed base index.

The counterpart of ``duckdb_faiss_ext_tpu/models/refine.py``
(faiss::IndexRefineFlat, reachable in the reference through any
``...,RFlat`` factory string: the reference forwards factory strings to
faiss::index_factory verbatim, src/faiss_extension.cpp:154-155).  The base
index (PQ / SQ / IVF-PQ …) produces k_base = min(max(k, round(k·k_factor)),
ntotal) candidates; the wrapper re-scores them against the raw fp32 rows
and returns the exact top-k.

The raw store is an inner ``FlatIndex`` (its padded device buffer); the
re-rank is one gather, a distance (difference form for L2, a dot for inner
product) and a top-k over the (nq, k_base) candidates on the index's
device, always in fp32 (elementwise products, never a TF32 matmul).  Range
search is answered by the raw store, exactly.  The Flat index's opt-in
``rerank`` search parameter runs the same rerank.  State: ``base`` and
``refine_xb``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..ops.distance import elementwise_scores
from ..ops.flat_search import SIMILARITY_METRICS, exact_topk
from ..params import EMPTY
from ..utils.config import pad_rows
from ..utils.transfer import upload_query_batch
from .base import Dispatch, Index, SearchResult, as_matrix
from .flat import FlatIndex


def rerank(xb, labels, xq, k: int, metric: str, metric_arg: float = 0.0):
    """Exact re-rank: score xq (nq, d) against xb[labels] (labels (nq, kb)
    storage positions, -1 = missing stays missing) in fp32; returns
    best-first (distances (nq, k), positions (nq, k)) with FAISS sentinels
    where missing; equal scores keep the base's order."""
    xc = xb[labels.clamp(min=0).long()]                 # (nq, kb, d)
    # Elementwise fp32 products and sums: no TF32 matmul, whatever the
    # precision mode.
    if metric == "INNER_PRODUCT":
        s = (xc * xq[:, None, :]).sum(-1)
    elif metric == "L2":
        diff = xc - xq[:, None, :]
        s = -(diff * diff).sum(-1)
    else:
        d = elementwise_scores(xq[:, None, :], xc, metric, metric_arg)
        s = d if metric in SIMILARITY_METRICS else -d
    s = torch.where(labels >= 0, s, float("-inf"))
    best, sel = exact_topk(s, k)
    pos = torch.where(torch.isneginf(best), -1, labels.gather(1, sel))
    # A missing slot's -inf score is already the sentinel of either sign.
    return (best if metric in SIMILARITY_METRICS else -best), pos


class RefineFlatIndex(Index):
    """IndexRefineFlat analogue: base candidates re-scored on raw rows."""

    def __init__(self, base: Index):
        super().__init__(base.d, base.metric, base.metric_arg)
        self.base = base
        self.k_factor_default = 1.0   # faiss::IndexRefineFlat::k_factor
        self.refine = FlatIndex(base.d, base.metric, base.metric_arg)

    # --- lifecycle -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self.base.ntotal

    @property
    def is_trained(self) -> bool:
        return self.base.is_trained

    @property
    def requires_training(self) -> bool:
        return self.base.requires_training

    def train(self, x) -> None:
        self.base.train(x)

    def add(self, x) -> None:
        x = as_matrix(x, self.d)
        self.base.add(x)
        self.refine.add(x)

    def reconstruct(self, key: int) -> np.ndarray:
        return self.refine.reconstruct(key)

    def row_labels(self) -> np.ndarray:
        return self.base.row_labels()

    def apply_create_params(self, params) -> None:
        self.base.apply_create_params(params)

    # --- search ----------------------------------------------------------
    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        k = int(k)
        if nq == 0 or k <= 0 or self.ntotal == 0:
            return self.base.search(xq, k, params, selector)
        k_factor = params.get_float("k_factor", self.k_factor_default)
        if k_factor < 1.0:
            raise errors.InvalidInputError(
                f"k_factor must be >= 1 (got {k_factor})")
        k_base = min(max(k, int(round(k * k_factor))), self.ntotal)
        # Base labels are storage positions for every wrappable base, the
        # contract of faiss::IndexRefine, which indexes its store by them.
        base = self.base.search(xq, k_base, params, selector)
        dev = self.refine.device
        xq_dev = upload_query_batch(xq, dev)
        labels = torch.from_numpy(pad_rows(base.labels.astype(np.int64),
                                           xq_dev.shape[0], fill=-1)).to(dev)
        k_eff = min(k, k_base)
        dist, pos = rerank(self.refine.device_vectors(), labels, xq_dev,
                           k_eff, self.metric.name, self.metric_arg)
        return self.finish(Dispatch(dist, pos, nq, k_eff), nq, k)

    def range_search(self, xq, radius, params=EMPTY, selector=None):
        # Exact by construction: the raw store answers directly.
        return self.refine.range_search(xq, radius, params, selector)

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(),
                "refine_xb": self.refine.vectors()}

    def load_state(self, state: dict) -> None:
        self.base.load_state(state.get("base", {}))
        self.refine.load_state({"xb": state["refine_xb"]})
