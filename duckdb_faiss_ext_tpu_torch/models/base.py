"""Base index interface and selector resolution.

Mirrors the slice of ``faiss::Index`` the reference uses (train / add /
add_with_ids / search / serialization — SURVEY.md §2.2): device buffers
padded to capacity buckets, and selectors resolved to per-row boolean masks
fused into the search kernel.
"""

from __future__ import annotations

import abc
from typing import NamedTuple, TYPE_CHECKING

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..params import EMPTY, ParamMap
from ..utils.transfer import fetch_results

if TYPE_CHECKING:
    from ..ops.selectors import Selector


class SearchResult(NamedTuple):
    """Search output: best-first per query, padded to k.

    Matches the reference's result schema LIST(STRUCT(rank, label, distance))
    with label = -1 and a sentinel distance for missing slots
    (src/faiss_extension.cpp:640-662)."""

    distances: np.ndarray  # (nq, k) float32
    labels: np.ndarray     # (nq, k) int64, -1 where missing


class Index(abc.ABC):
    """Abstract index. Subclasses implement storage + search; composition
    (IDMap, IVF-with-quantizer) is a graph of these objects, like FAISS's
    index graph built by index_factory."""

    #: factory description that produced this index (for save/load round-trip)
    factory_desc: str = ""

    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0):
        self.d = int(d)
        self.metric = metric
        self.metric_arg = float(metric_arg)

    # --- lifecycle -------------------------------------------------------
    @property
    @abc.abstractmethod
    def ntotal(self) -> int:
        ...

    @property
    def is_trained(self) -> bool:
        return True

    @property
    def requires_training(self) -> bool:
        """Whether this index type needs a train() call before add()
        (drives the entry's needs_training latch, src/include/index.hpp:27)."""
        return False

    def train(self, x: np.ndarray) -> None:  # noqa: B027  (no-op default)
        """Train on (n, d) fp32 data. No-op when already trained, mirroring
        FAISS Level1Quantizer::train_q1 skipping a trained quantizer."""

    @abc.abstractmethod
    def add(self, x: np.ndarray) -> None:
        ...

    def add_with_ids(self, x: np.ndarray, ids: np.ndarray) -> None:
        # FAISS throws from Index::add_with_ids for non-IDMap types; the
        # extension rewraps it (src/faiss_extension.cpp:524).
        raise errors.add_with_ids_unsupported()

    # --- search ----------------------------------------------------------
    @abc.abstractmethod
    def search(
        self,
        xq: np.ndarray,
        k: int,
        params: ParamMap = EMPTY,
        selector: "Selector | None" = None,
    ) -> SearchResult:
        ...

    def range_search(self, xq, radius: float, params: ParamMap = EMPTY,
                     selector: "Selector | None" = None):
        """All neighbors within ``radius`` (faiss::Index::range_search) as a
        CSR ``ops.range.RangeSearchResult``.  Beyond the reference's SQL
        surface; served by the dense-scan families (Flat / SQ / PQ / RQ /
        IVF) and the wrappers over them."""
        raise errors.InvalidInputError(
            f"range search is not supported for {type(self).__name__}")

    # --- selector plumbing ------------------------------------------------
    def row_labels(self) -> np.ndarray:
        """int64 label of every stored row, in storage order — the ids a
        selector filters on (FAISS IDSelector semantics)."""
        return np.arange(self.ntotal, dtype=np.int64)

    def _positions_to_labels(self, pos: np.ndarray) -> np.ndarray:
        """Map storage positions in search output to user-visible labels.
        Identity by default (positions ARE labels for dense storage:
        Flat); overridden where labels indirect through a table (IDMap)."""
        return pos

    @staticmethod
    def _pad_result(dist, labels, nq: int, k: int, k_eff: int,
                    sentinel: float) -> "SearchResult":
        """Pad (nq, k_eff) results out to k columns with sentinel distances
        and label -1 (src/faiss_extension.cpp:640-662)."""
        if k_eff < k:
            dist = np.concatenate(
                [dist, np.full((nq, k - k_eff), sentinel, np.float32)], 1)
            labels = np.concatenate(
                [labels, np.full((nq, k - k_eff), -1, np.int64)], 1)
        return SearchResult(dist, labels)

    def _finish_dispatch(self, disp, xq, k: int) -> "SearchResult":
        """Shared search epilogue over a ``search_dispatch`` tuple: one
        device→host fetch, position→label mapping, sentinel padding to k.
        ``disp`` is (dist_dev, pos_dev, nq, k_eff[, to_labels[, post]]) or
        None for no device work (empty queries, k≤0, empty IVF index)."""
        from ..ops.flat_search import SIMILARITY_METRICS

        k = int(k)
        sentinel = (float("-inf")
                    if self.metric.name in SIMILARITY_METRICS
                    else float("inf"))
        if disp is None:
            nq = as_matrix(xq, self.d).shape[0]
            return SearchResult(
                np.full((nq, max(k, 0)), sentinel, np.float32),
                np.full((nq, max(k, 0)), -1, np.int64))
        nq = disp[2]
        dist, pos = fetch_results(disp[0][:nq], disp[1][:nq])
        dist, labels, k_eff = self._map_dispatch(disp, dist,
                                                 pos.astype(np.int64))
        return self._pad_result(dist, labels, nq, k, k_eff, sentinel)

    def _map_dispatch(self, disp, dist: np.ndarray, pos: np.ndarray):
        """Host side of one dispatch after the fetch: positions → labels
        through the dispatch's own mapper (5th element; IVF maps layout
        positions through its ids) or ``_positions_to_labels``, then the
        optional host post-process (6th element, ``post(dist, labels,
        pos) -> (dist, labels)``, which may change the width).  Returns
        (dist, labels, k_eff)."""
        to_labels = disp[4] if len(disp) > 4 else self._positions_to_labels
        labels = to_labels(pos)
        k_eff = disp[3]
        if len(disp) > 5:
            dist, labels = disp[5](dist, labels, pos)
            k_eff = dist.shape[1]
        return dist, labels, k_eff

    # --- create-time parameters (setIndexParameters recursion,
    #     src/faiss_extension.cpp:123-144) --------------------------------
    def apply_create_params(self, params: ParamMap) -> None:  # noqa: B027
        pass

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        """Arrays + metadata for the versioned checkpoint (io/serialize.py),
        the analogue of faiss write_index (src/faiss_extension.cpp:199)."""
        return {}

    def load_state(self, state: dict) -> None:  # noqa: B027
        pass

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(d={self.d}, metric={self.metric.name}, "
                f"ntotal={self.ntotal})")


def as_matrix(x, d: int, *, name: str = "vectors") -> np.ndarray:
    """Validate/convert input vectors to (n, d) float32, mirroring
    ListVectorToFaiss's checks (src/faiss_extension.cpp:267-295)."""
    arr = np.asarray(x, dtype=np.float32)
    if arr.ndim == 1:
        if d != 0 and arr.size % d == 0:
            arr = arr.reshape(-1, d)
        else:
            raise errors.need_list_type()
    if arr.ndim != 2:
        raise errors.need_list_type()
    if arr.shape[1] != d:
        raise errors.bad_vector_length(d, arr.shape[1], 0)
    return np.ascontiguousarray(arr)


def dedup_by_key(dist, labels, keys, k: int, sentinel: float):
    """Keep the best-ranked entry per key and repack to width k.

    SOAR stores every datapoint in two inverted lists, so a 2k-candidate
    fetch can hold a source row twice.  ``keys`` identifies duplicates (the
    logical source row where the mapper provides one, else the label).
    Rows arrive best-first; the first occurrence stays, the rest become
    (sentinel, -1), and the survivors are stably compacted left (the JAX
    package's ``dedup_by_key``, host numpy)."""
    nq, w = labels.shape
    order = np.argsort(keys, axis=1, kind="stable")
    k_sorted = np.take_along_axis(keys, order, 1)
    dup_sorted = np.zeros((nq, w), bool)
    dup_sorted[:, 1:] = (k_sorted[:, 1:] == k_sorted[:, :-1]) \
        & (k_sorted[:, 1:] >= 0)
    dup = np.zeros((nq, w), bool)
    np.put_along_axis(dup, order, dup_sorted, 1)
    dist = np.where(dup, sentinel, dist).astype(np.float32)
    labels = np.where(dup, -1, labels)
    compact = np.argsort(dup, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(dist, compact, 1),
            np.take_along_axis(labels, compact, 1))


def row_placement(mesh):
    """Row placement of padded storage over ``mesh``'s 'shard' axis (shared
    by every codec family's shard_over); checks the mesh's axes once."""
    from ..parallel.placement import RowPlacement

    if "shard" not in mesh.shape:
        raise errors.InvalidInputError(
            "sharding needs a mesh with a 'shard' axis "
            "(parallel.placement.default_mesh builds one)")
    return RowPlacement(mesh)


def placement_capacity(cap: int, placement) -> int:
    """A capacity bucket rounded up to a multiple of the placement's device
    count (row blocks of equal rows)."""
    return cap if placement is None else placement.capacity(cap)
