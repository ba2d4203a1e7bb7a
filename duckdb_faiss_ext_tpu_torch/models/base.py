"""Base index interface and selector resolution.

Mirrors the slice of ``faiss::Index`` the reference uses (train / add /
add_with_ids / search / serialization — SURVEY.md §2.2): device buffers
padded to capacity buckets, and selectors resolved to per-row boolean masks
fused into the search kernel.

A search's way in and way out are here too.  ``Index.search`` checks the
queries once; every family's ``search_dispatch`` pads them with
``utils.transfer.upload_query_batch`` and returns a ``Dispatch`` (the
device answers and the tables that map their positions to labels), and
``finish_dispatches`` is the one epilogue: fetch, map, SOAR's dedup, pad
to k.
"""

from __future__ import annotations

import abc
from typing import NamedTuple, TYPE_CHECKING

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..ops.flat_search import SIMILARITY_METRICS
from ..params import EMPTY, ParamMap
from ..utils.profiling import spanned
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


class Dispatch(NamedTuple):
    """A search's answers on the device, before the host fetch: what every
    family's ``search_dispatch`` returns and ``finish_dispatches`` takes.

    Rows past ``nq`` answer the padding queries and are dropped.  The
    positions become labels through ``tables`` in order (``map_labels``);
    an empty tuple means the positions are the labels.  With ``dedup_k``
    (SOAR, every row stored twice) the best-ranked entry per key is kept
    and the answers repacked to ``dedup_k`` columns; the key of a position
    is its entry in ``dedup_keys`` (the source row), or its label where
    that is None."""

    dist: torch.Tensor      # (nq_pad, k_eff) float32 distances
    pos: torch.Tensor       # (nq_pad, k_eff) storage positions, -1 missing
    nq: int
    k_eff: int
    tables: tuple = ()
    dedup_k: int = 0
    dedup_keys: "np.ndarray | None" = None


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
    def search(
        self,
        xq: np.ndarray,
        k: int,
        params: ParamMap = EMPTY,
        selector: "Selector | None" = None,
    ) -> SearchResult:
        """The k best (distances, labels) of each query, best first and
        padded to k (faiss::Index::search).  The queries are checked here
        once; the family's ``search_dispatch`` takes them checked, and
        ``finish`` brings its answers to the host.  Indexes without a
        device dispatch override this."""
        xq = as_matrix(xq, self.d)
        return self.finish(self._dispatch(xq, k, params, selector),
                           xq.shape[0], k)

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

    @property
    def sentinel(self) -> float:
        """The distance of a missing result slot: -inf under a similarity
        metric, else +inf (src/faiss_extension.cpp:640-662)."""
        return (float("-inf") if self.metric.name in SIMILARITY_METRICS
                else float("inf"))

    @spanned("models.dispatch")
    def _dispatch(self, xq, k, params, selector):
        """``search_dispatch`` inside the dispatch span."""
        return self.search_dispatch(xq, k, params, selector)

    def finish(self, disp: "Dispatch | None", nq: int, k: int) -> SearchResult:
        """A search's answers from its dispatch (``finish_dispatches``), or
        nq rows of missing slots where no device work applied (disp None:
        no queries, k ≤ 0, an empty IVF index)."""
        k = int(k)
        if disp is None:
            return SearchResult(
                np.full((nq, max(k, 0)), self.sentinel, np.float32),
                np.full((nq, max(k, 0)), -1, np.int64))
        return finish_dispatches([disp], k, self.sentinel)

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


def map_labels(pos: np.ndarray, tables) -> np.ndarray:
    """Positions → labels through each table in turn: entry ``pos`` of the
    table, -1 where ``pos`` is -1; an empty table passes positions on."""
    for table in tables:
        pos = np.where(pos >= 0, table[np.clip(pos, 0, None)]
                       if table.size else pos, -1)
    return pos


def finish_dispatches(disps, k: int, sentinel: float) -> SearchResult:
    """The search epilogue over the dispatches of one search's query
    batches, in order: one device→host fetch of all their answer rows,
    then each batch's positions mapped to labels, SOAR's duplicates
    dropped and the answers padded to k (``_labelled``)."""
    if len(disps) == 1:     # (torch.cat would add a copy on the device)
        d = disps[0]
        return _labelled(d, *fetch_results(d.dist[:d.nq], d.pos[:d.nq]), k,
                         sentinel)
    dist, pos = fetch_results(torch.cat([d.dist[:d.nq] for d in disps]),
                              torch.cat([d.pos[:d.nq] for d in disps]))
    parts, row = [], 0
    for d in disps:
        parts.append(_labelled(d, dist[row:row + d.nq], pos[row:row + d.nq],
                               k, sentinel))
        row += d.nq
    return SearchResult(np.concatenate([p.distances for p in parts]),
                        np.concatenate([p.labels for p in parts]))


@spanned("models.labels")
def _labelled(disp: Dispatch, dist: np.ndarray, pos: np.ndarray, k: int,
              sentinel: float) -> SearchResult:
    """One fetched dispatch's positions as labels, deduplicated under SOAR,
    padded to k columns with (sentinel, -1)."""
    pos = pos.astype(np.int64)
    labels = map_labels(pos, disp.tables)
    if disp.dedup_k:
        keys = (labels if disp.dedup_keys is None
                else map_labels(pos, (disp.dedup_keys,)))
        dist, labels = dedup_by_key(dist, labels, keys, disp.dedup_k,
                                    sentinel)
    nq, width = labels.shape
    if width < k:
        dist = np.concatenate(
            [dist, np.full((nq, k - width), sentinel, np.float32)], 1)
        labels = np.concatenate(
            [labels, np.full((nq, k - width), -1, np.int64)], 1)
    return SearchResult(dist, labels)


def dedup_by_key(dist, labels, keys, k: int, sentinel: float):
    """Keep the best-ranked entry per key and repack to width k.

    SOAR stores every datapoint in two inverted lists, so a 2k-candidate
    fetch can hold a source row twice.  ``keys`` identifies duplicates (the
    logical source row where the dispatch carries one, else the label).
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
