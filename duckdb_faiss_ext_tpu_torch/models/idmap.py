"""IDMap wrapper: custom int64 labels over an inner index.

Equivalent of faiss::IndexIDMap (over Flat or IVF) as the reference uses it
(src/faiss_extension.cpp:127-131,671-674): add_with_ids records a label per
stored row; search results are translated position→label after top-k; create
and search parameters recurse to the inner index unchanged.

Selectors filter on *labels* (FAISS translates its IDSelector through the id
map): a selector is resolved against the label table and handed to the
inner index as a position mask.  ``reconstruct`` takes a label (IDMap2).
"""

from __future__ import annotations

import numpy as np

from .. import errors
from ..params import EMPTY
from .base import Index, SearchResult, as_matrix


class IDMapIndex(Index):
    def __init__(self, inner: Index):
        super().__init__(inner.d, inner.metric, inner.metric_arg)
        self.inner = inner
        self._labels = np.empty((0,), dtype=np.int64)

    @property
    def ntotal(self) -> int:
        return self.inner.ntotal

    @property
    def is_trained(self) -> bool:
        return self.inner.is_trained

    @property
    def requires_training(self) -> bool:
        return self.inner.requires_training

    def train(self, x) -> None:
        self.inner.train(x)

    def add(self, x) -> None:
        # FAISS IndexIDMap::add throws; the extension surfaces it via the
        # "Unable to add data: %s" wrapper (src/faiss_extension.cpp:528).
        raise errors.add_error(
            "add does not support adding without ids on an IDMap index; "
            "use two input columns (id, vector)")

    def add_with_ids(self, x, ids) -> None:
        x = as_matrix(x, self.d)
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.shape[0] != x.shape[0]:
            raise errors.add_error(
                f"number of ids ({ids.shape[0]}) does not match number of "
                f"vectors ({x.shape[0]})")
        self.inner.add(x)
        self._labels = np.concatenate([self._labels, ids])

    def row_labels(self) -> np.ndarray:
        return self._labels

    def _position_selector(self, selector):
        """Label-space selector → position-space selector for the inner
        index: positions whose label passes."""
        return _PositionMaskSelector(selector.contains(self._labels),
                                     (selector.cache_key(),
                                      len(self._labels)))

    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        return self._finish_dispatch(
            self.search_dispatch(xq, k, params, selector), xq, k)

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """The inner index's device dispatch with the selector translated to
        position space; positions map back to labels in
        ``_positions_to_labels`` after the fetch."""
        if selector is not None:
            selector = self._position_selector(selector)
        disp = self.inner.search_dispatch(xq, k, params, selector)
        if disp is None or len(disp) <= 4:
            return disp
        # The inner dispatch carries its own positions → ids mapper (IVF);
        # its ids are our storage positions, so compose with the label
        # table and keep any host post-process.
        inner_labels = disp[4]
        return disp[:4] + (
            lambda pos: self._positions_to_labels(inner_labels(pos)),
        ) + tuple(disp[5:])

    def _positions_to_labels(self, pos: np.ndarray) -> np.ndarray:
        return np.where(pos >= 0, self._labels[np.clip(pos, 0, None)]
                        if self._labels.size else pos, -1)

    def reconstruct(self, label: int) -> np.ndarray:
        """The stored vector of a custom label (faiss IndexIDMap2; plain
        IDMap answers too, as in the JAX package), decoded by the inner
        index for coded storage."""
        matches = np.nonzero(self._labels == int(label))[0]
        if matches.size == 0:
            raise errors.InvalidInputError(f"Label {label} not found in index")
        inner_rec = getattr(self.inner, "reconstruct", None)
        if inner_rec is None:
            raise errors.InvalidInputError(
                f"reconstruct is not supported by {type(self.inner).__name__}")
        return inner_rec(int(matches[0]))

    def apply_create_params(self, params) -> None:
        # setIndexParameters unwraps IDMap and recurses
        # (src/faiss_extension.cpp:127-131).
        self.inner.apply_create_params(params)

    def state_dict(self) -> dict:
        return {"labels": self._labels, "inner": self.inner.state_dict()}

    def load_state(self, state: dict) -> None:
        self._labels = np.asarray(state["labels"], dtype=np.int64).reshape(-1)
        self.inner.load_state(state["inner"])


class _PositionMaskSelector:
    """Adapter: a precomputed row mask presented through the Selector
    interface (position-space, already label-resolved).  The cache key
    derives from the originating selector's unique id, so it stays valid
    exactly as long as that selector's own cached masks."""

    def __init__(self, mask: np.ndarray, key):
        self._mask = np.asarray(mask, dtype=bool)
        self._key = ("posmask", key)

    def contains(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels, dtype=np.int64)
        out = np.zeros(labels.shape, dtype=bool)
        in_range = (labels >= 0) & (labels < self._mask.size)
        out[in_range] = self._mask[labels[in_range]]
        return out

    def cache_key(self):
        return self._key
