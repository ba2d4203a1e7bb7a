"""IDMap wrapper: custom int64 labels over an inner index.

Equivalent of faiss::IndexIDMap (over any inner index) as the reference uses it
(src/faiss_extension.cpp:127-131,671-674): add_with_ids records a label per
stored row; search results are translated position→label after top-k; create
and search parameters recurse to the inner index unchanged.

Selectors filter on *labels* (FAISS translates its IDSelector through the id
map): the inner index gets the selector with the label table
(``ops.selectors.LabelMapSelector``), so an IVF inner index tests the labels
on the device from a table uploaded once per device and label version, and
any other inner index tests them where its own mask is built.
``reconstruct`` takes a label (IDMap2).
"""

from __future__ import annotations

import numpy as np

from .. import errors
from ..ops.selectors import LabelMapSelector, labels_for_device_mask
from ..params import EMPTY
from .base import Index, SearchResult, as_matrix, map_labels


class IDMapIndex(Index):
    def __init__(self, inner: Index):
        super().__init__(inner.d, inner.metric, inner.metric_arg)
        self.inner = inner
        self._labels = np.empty((0,), dtype=np.int64)
        self._labels_dev: dict = {}

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
        ids = _checked_ids(ids, x.shape[0])
        self.inner.add(x)
        self._labels = np.concatenate([self._labels, ids])
        self._labels_dev = {}

    def add_device(self, x, ids, **layout) -> None:
        """``add_with_ids`` for rows on the device: the rows go to the inner
        index's ``add_device`` (with ``layout``, its sizing keywords) and
        only the labels are kept here, on the host.  An inner index without
        device-resident ingest is refused as faiss_add_device refuses one
        at the top."""
        if not hasattr(self.inner, "add_device"):
            raise errors.no_device_ingest(
                f"IDMap over {type(self.inner).__name__}")
        if ids is None:
            raise errors.add_error(
                "add does not support adding without ids on an IDMap "
                "index; give faiss_add_device the ids")
        ids = _checked_ids(ids, x.shape[0])
        self.inner.add_device(x, None, **layout)
        self._labels = np.concatenate([self._labels, ids])
        self._labels_dev = {}

    def row_labels(self) -> np.ndarray:
        return self._labels

    def _position_selector(self, selector) -> LabelMapSelector:
        """Label-space selector → position-space selector for the inner
        index: positions whose label passes."""
        return LabelMapSelector(selector, self._labels, self._device_labels)

    def _device_labels(self, device):
        """The label table as device masks read it, cached per device until
        the labels change."""
        if device not in self._labels_dev:
            self._labels_dev[device] = labels_for_device_mask(self._labels,
                                                              device)
        return self._labels_dev[device]

    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        xq = as_matrix(xq, self.d)
        disp = self._dispatch(xq, k, params, selector)
        if disp is not None:
            return self.finish(disp, xq.shape[0], k)
        # No device dispatch (RefineFlat, an HNSW index with a tail to
        # merge or in its IVF regime, no queries): the inner index's own
        # search, positions mapped to labels after it.
        if selector is not None:
            selector = self._position_selector(selector)
        dist, pos = self.inner.search(xq, k, params, selector)
        return SearchResult(dist, map_labels(pos, (self._labels,)))

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """The inner index's device dispatch with the selector translated to
        position space, and the label table after the inner index's own
        tables (its labels are our storage positions).  None where the
        inner index has no dispatch (the batched search then searches)."""
        inner = getattr(self.inner, "search_dispatch", None)
        if inner is None:
            return None
        if selector is not None:
            selector = self._position_selector(selector)
        disp = inner(xq, k, params, selector)
        if disp is None:
            return None
        return disp._replace(tables=disp.tables + (self._labels,))

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

    def range_search(self, xq, radius, params=EMPTY, selector=None):
        """The inner index's range search with the selector translated to
        position space and its positions translated to labels."""
        from ..ops.range import RangeSearchResult

        if selector is not None:
            selector = self._position_selector(selector)
        res = self.inner.range_search(xq, radius, params, selector)
        labels = self._labels[res.labels] if self._labels.size else res.labels
        return RangeSearchResult(res.lims, labels, res.distances)

    def apply_create_params(self, params) -> None:
        # setIndexParameters unwraps IDMap and recurses
        # (src/faiss_extension.cpp:127-131).
        self.inner.apply_create_params(params)

    def state_dict(self) -> dict:
        return {"labels": self._labels, "inner": self.inner.state_dict()}

    def load_state(self, state: dict) -> None:
        self._labels = np.asarray(state["labels"], dtype=np.int64).reshape(-1)
        self._labels_dev = {}
        self.inner.load_state(state["inner"])


def _checked_ids(ids, n: int) -> np.ndarray:
    """``ids`` as int64 labels, one for each of the ``n`` rows added."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    if ids.shape[0] != n:
        raise errors.add_error(
            f"number of ids ({ids.shape[0]}) does not match number of "
            f"vectors ({n})")
    return ids
