"""PreTransform wrapper: apply vector transforms before an inner index.

The counterpart of ``duckdb_faiss_ext_tpu/models/pretransform.py``
(faiss::IndexPreTransform as factory prefixes build it: ``PCA64,IVF...``,
``OPQ16,IVF...,PQ16``, ``L2norm,Flat``; the grammar the reference forwards
to faiss::index_factory, src/faiss_extension.cpp:154-155).  Training fits
each transform on the already-transformed training data, then trains the
inner index in transform space; add, search and range search apply the
chain (transforms.py, on the index's device) before delegating.

State: ``inner`` and ``vt{i}`` for each transform with trained state.
"""

from __future__ import annotations

import numpy as np

from .. import errors
from ..params import EMPTY
from ..transforms import VectorTransform
from .base import Index, SearchResult, as_matrix


class PreTransformIndex(Index):
    def __init__(self, transforms: list[VectorTransform], inner: Index):
        # Outer dimension is the first transform's input dim.
        super().__init__(transforms[0].d_in, inner.metric, inner.metric_arg)
        self.transforms = list(transforms)
        self.inner = inner

    # --- lifecycle -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self.inner.ntotal

    @property
    def is_trained(self) -> bool:
        return (all(t.is_trained for t in self.transforms)
                and self.inner.is_trained)

    @property
    def requires_training(self) -> bool:
        return (self.inner.requires_training
                or any(not t.is_trained for t in self.transforms))

    def train(self, x) -> None:
        x = as_matrix(x, self.d)
        for t in self.transforms:
            t.train(x)
            x = t.apply(x)
        self.inner.train(x)

    def apply_chain(self, x) -> np.ndarray:
        """Rows (n, d) through every transform: (n, inner.d)."""
        x = as_matrix(x, self.d)
        for t in self.transforms:
            x = t.apply(x)
        return x

    # --- ingest ----------------------------------------------------------
    def add(self, x) -> None:
        self.inner.add(self.apply_chain(x))

    def add_with_ids(self, x, ids) -> None:
        self.inner.add_with_ids(self.apply_chain(x), ids)

    def reconstruct(self, key: int) -> np.ndarray:
        inner_rec = getattr(self.inner, "reconstruct", None)
        if inner_rec is None:
            raise errors.InvalidInputError(
                f"reconstruct is not supported by {type(self.inner).__name__}")
        y = np.asarray(inner_rec(key), np.float32)[None, :]
        for t in reversed(self.transforms):
            y = t.reverse(y)
        return y[0]

    def row_labels(self) -> np.ndarray:
        return self.inner.row_labels()

    def apply_create_params(self, params) -> None:
        self.inner.apply_create_params(params)

    # --- search ----------------------------------------------------------
    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        xq = as_matrix(xq, self.d)
        if xq.shape[0] == 0:
            return self.inner.search(
                np.empty((0, self.inner.d), np.float32), k, params, selector)
        return self.inner.search(self.apply_chain(xq), k, params, selector)

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """The inner index's device dispatch on the transformed queries, or
        None where it has none (RefineFlat) or there are no queries."""
        inner = getattr(self.inner, "search_dispatch", None)
        if inner is None or xq.shape[0] == 0:
            return None
        return inner(self.apply_chain(xq), k, params, selector)

    def range_search(self, xq, radius, params=EMPTY, selector=None):
        return self.inner.range_search(self.apply_chain(xq), radius, params,
                                       selector)

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        state = {"inner": self.inner.state_dict()}
        for i, t in enumerate(self.transforms):
            ts = t.state_dict()
            if ts:
                state[f"vt{i}"] = ts
        return state

    def load_state(self, state: dict) -> None:
        for i, t in enumerate(self.transforms):
            t.load_state(state.get(f"vt{i}", {}))
        self.inner.load_state(state.get("inner", {}))
