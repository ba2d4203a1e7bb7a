"""Public operator surface: the reference's 12 SQL functions as Python ops.

One function per SQL function registered by LoadInternal
(src/faiss_extension.cpp:1025-1149):

    faiss_create, faiss_create_params, faiss_save, faiss_load,
    faiss_destroy, faiss_manual_train, faiss_add, create_mask
    (__faiss_create_mask analogue), faiss_search, faiss_search_filter,
    faiss_search_filter_set

and the JAX package's extensions faiss_search_batched, faiss_stats and
the device-resident ingest of rows already on the card,
faiss_train_device and faiss_add_device.

faiss_to_gpu (the JAX package's faiss_to_device) is not ported yet: an index
lives on ``config.device`` from its creation.

Semantics (lifecycle errors, label latching, deferred training, immutability
of loaded indexes, result schema padded to k with label −1) follow the
reference; each function cites where.  Results are numpy structured arrays
with fields (rank int32, label int64, distance float32), the analogue of the
reference's LIST(STRUCT(rank, label, distance)) (src/faiss_extension.cpp:640-662).
"""

from __future__ import annotations

import functools
import threading
from typing import Mapping, Optional

import numpy as np
import torch

from . import errors
from .catalog import GLOBAL_CATALOG, Catalog, IndexEntry
from .factory import build_index
from .metrics import DEFAULT_METRIC, resolve_metric
from .models.base import SearchResult, as_matrix, fetch_results
from .ops.flat_search import SIMILARITY_METRICS
from .ops.selectors import BitmapSelector, Selector, SetSelector
from .params import as_params
from .utils.profiling import timed


def _timed_op(op: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with timed(op):
                return fn(*args, **kwargs)
        return wrapper
    return deco

RESULT_DTYPE = np.dtype(
    [("rank", np.int32), ("label", np.int64), ("distance", np.float32)]
)


def _cat(catalog: Optional[Catalog]) -> Catalog:
    return catalog if catalog is not None else GLOBAL_CATALOG


# --------------------------------------------------------------------------
# Creation / deletion
# --------------------------------------------------------------------------

# Named-parameter handler registry for faiss_create* — the reference's
# extensibility point (RegisterCreateParameter, src/faiss_extension.cpp:80-94;
# only metric_type is registered there, same here).
_CREATE_PARAM_HANDLERS: dict = {}


def register_create_parameter(key: str, handler) -> None:
    """Register a named-parameter handler for faiss_create/faiss_create_params.
    ``handler(index, value)`` runs after index construction."""
    _CREATE_PARAM_HANDLERS[key] = handler


def faiss_create(name: str, dimension: int, index_type: str,
                 catalog: Catalog | None = None, **named) -> None:
    """CALL faiss_create(name, dim, type[, metric_type=...])
    (CreateBind/CreateFunction, src/faiss_extension.cpp:70-164)."""
    faiss_create_params(name, dimension, index_type, None,
                        catalog=catalog, **named)


def faiss_create_params(name: str, dimension: int, index_type: str,
                        parameters: Mapping[str, object] | None,
                        catalog: Catalog | None = None, **named) -> None:
    """CALL faiss_create_params(name, dim, type, MAP) — create-time params
    applied through the index graph (setIndexParameters recursion,
    src/faiss_extension.cpp:123-144)."""
    metric_name = DEFAULT_METRIC  # default INNER_PRODUCT (:105)
    deferred = []
    for key, value in named.items():
        # Named-parameter handler registry (:80-94); metric_type built in,
        # others via register_create_parameter.
        if key == "metric_type":
            metric_name = str(value)
        elif key in _CREATE_PARAM_HANDLERS:
            deferred.append((_CREATE_PARAM_HANDLERS[key], value))
        else:
            raise errors.unknown_named_parameter(key)
    metric = resolve_metric(metric_name)

    params = as_params(parameters)
    metric_arg = params.get_float("metric_arg", 0.0)
    index = build_index(int(dimension), index_type, metric, metric_arg)
    index.apply_create_params(params)
    for handler, value in deferred:
        handler(index, value)

    entry = IndexEntry(index=index,
                       needs_training=index.requires_training)
    _cat(catalog).put_new(name, entry)


def faiss_destroy(name: str, catalog: Catalog | None = None) -> None:
    """CALL faiss_destroy(name) (src/faiss_extension.cpp:242-265)."""
    _cat(catalog).delete(name)


# --------------------------------------------------------------------------
# Training / adding
# --------------------------------------------------------------------------

def _parse_add_input(data, d: int):
    """Accept (n, d) vectors, or (ids, vectors) for labeled adds — the
    1-column vs 2-column input of faiss_add (src/faiss_extension.cpp:423-456)."""
    if isinstance(data, tuple) and len(data) == 2:
        ids, vectors = data
        return (np.asarray(ids, dtype=np.int64).reshape(-1),
                as_matrix(vectors, d))
    return None, as_matrix(data, d)


@_timed_op("faiss_add")
def faiss_add(data, name: str, catalog: Catalog | None = None) -> None:
    """CALL faiss_add(data, name) — streaming ingest with the custom-labels
    latch and deferred training (src/faiss_extension.cpp:417-615)."""
    entry = _cat(catalog).get(name)
    with entry.lock:
        if not entry.is_mutable:
            raise errors.immutable_add()  # :486
        labels, x = _parse_add_input(data, entry.index.d)
        has_labels = labels is not None
        if has_labels and labels.shape[0] != x.shape[0]:
            raise errors.add_error(
                f"number of ids ({labels.shape[0]}) does not match number of "
                f"vectors ({x.shape[0]})")

        # Label-mode latch with mixing errors (:437-453).
        if entry.custom_labels is None:
            entry.custom_labels = has_labels
        elif entry.custom_labels != has_labels:
            raise errors.mixing_labels(with_labels_now=has_labels)

        if entry.needs_training and not entry.index.is_trained:
            # Deferred-training path: stage, train on everything staged so
            # far, then add only the un-added delta (:534-544, :601-610).
            entry.add_data.append(x)
            if has_labels:
                entry.add_labels.append(labels)
            all_x = entry.staged_vectors()
            try:
                entry.index.train(all_x)
            except errors.TrainingTooSmallError as e:
                entry.add_data.pop()
                if has_labels:
                    entry.add_labels.pop()
                raise errors.too_few_training_points(e, name) from None
            delta_x = all_x[entry.added:]
            try:
                if has_labels:
                    delta_l = entry.staged_labels()[entry.added:]
                    entry.index.add_with_ids(delta_x, delta_l)
                else:
                    entry.index.add(delta_x)
            except errors.InvalidInputError:
                # Same latch-reset rule as the direct path (:518-521): a
                # failed add on an empty index must not poison the label
                # latch or leave the failed batch staged.
                entry.add_data.pop()
                if has_labels:
                    entry.add_labels.pop()
                if entry.index.ntotal == 0:
                    entry.custom_labels = None
                raise
            entry.added = all_x.shape[0]
            # The staging copy is retained while training can still happen
            # (README.md:187); once trained it is dead weight — drop it
            # (documented deviation: saves memory, no observable change).
            entry.add_data = []
            entry.add_labels = []
        else:
            try:
                if has_labels:
                    entry.index.add_with_ids(x, labels)  # may raise :524
                else:
                    entry.index.add(x)
            except errors.InvalidInputError:
                # Failed labeled add on an empty index resets the latch
                # (src/faiss_extension.cpp:518-521).
                if has_labels and entry.index.ntotal == 0:
                    entry.custom_labels = None
                raise
            entry.added = entry.index.ntotal


@_timed_op("faiss_manual_train")
def faiss_manual_train(data, name: str, catalog: Catalog | None = None) -> None:
    """CALL faiss_manual_train(data, name) — explicit training; later adds
    skip retraining (MTrainFinaliseFunction, src/faiss_extension.cpp:297-415)."""
    entry = _cat(catalog).get(name)
    with entry.lock:
        if not entry.is_mutable:
            raise errors.immutable_train()  # :350
        x = as_matrix(data, entry.index.d)
        try:
            entry.index.train(x)
        except errors.TrainingTooSmallError as e:
            raise errors.too_few_training_points(e, None) from None
        entry.needs_training = False  # :411-413


@_timed_op("faiss_train_device")
def faiss_train_device(data, name: str,
                       catalog: Catalog | None = None) -> None:
    """faiss_manual_train for training rows already on the card (no
    reference analogue): the k-means and SQ range fit run on the device
    rows; only the centroid table comes back (models/ivf_device.py).
    ``data`` is a torch tensor, or an array moved to the index's device."""
    entry = _cat(catalog).get(name)
    with entry.lock:
        if not entry.is_mutable:
            raise errors.immutable_train()
        if not hasattr(entry.index, "train_device"):
            raise errors.InvalidInputError(
                f"index {name} does not support device-resident training "
                f"(IVF with Flat/SQ8/SQ4 storage does)")
        try:
            entry.index.train_device(data)
        except errors.TrainingTooSmallError as e:
            raise errors.too_few_training_points(e, None) from None
        entry.needs_training = False


@_timed_op("faiss_add_device")
def faiss_add_device(data, name: str, ids=None, *,
                     expected_total: int | None = None,
                     lmax: int | None = None,
                     spill_capacity: int | None = None,
                     catalog: Catalog | None = None) -> None:
    """Ingest rows already on the card (no reference analogue): assignment,
    SQ encoding and the scatter into the padded list layout run on the
    device; only integer bookkeeping reaches the host.  ``data`` is a torch
    tensor (never copied to the host), or an array moved to the index's
    device.  The index must be trained.  See models/ivf_device.py for the
    sizing (``expected_total`` / ``lmax``, ``spill_capacity``)."""
    entry = _cat(catalog).get(name)
    with entry.lock:
        if not entry.is_mutable:
            raise errors.immutable_add()
        if not hasattr(entry.index, "add_device"):
            raise errors.InvalidInputError(
                f"index {name} does not support device-resident ingest "
                f"(IVF with Flat/SQ8/SQ4 storage does)")
        has_labels = ids is not None
        if entry.custom_labels is None:
            entry.custom_labels = has_labels
        elif entry.custom_labels != has_labels:
            raise errors.mixing_labels(with_labels_now=has_labels)
        entry.index.add_device(data, ids, expected_total=expected_total,
                               lmax=lmax, spill_capacity=spill_capacity)
        entry.added = entry.index.ntotal


# --------------------------------------------------------------------------
# Search
# --------------------------------------------------------------------------

def _format_results(res: SearchResult, k: int) -> np.ndarray:
    nq = res.labels.shape[0]
    out = np.empty((nq, k), dtype=RESULT_DTYPE)
    out["rank"] = np.arange(k, dtype=np.int32)[None, :]
    out["label"] = res.labels
    out["distance"] = res.distances
    return out


@_timed_op("faiss_search")
def faiss_search(name: str, k: int, queries,
                 parameters: Mapping[str, object] | None = None,
                 catalog: Catalog | None = None,
                 selector: Selector | None = None) -> np.ndarray:
    """faiss_search(name, k, q[, MAP]) → (nq, k) structured results
    (SearchFunction → searchIntoVector, src/faiss_extension.cpp:903-925,
    619-666)."""
    entry = _cat(catalog).get(name)
    params = as_params(parameters)
    res = entry.index.search(as_matrix(queries, entry.index.d), int(k),
                             params, selector)
    return _format_results(res, int(k))


def create_mask(flags, ids) -> BitmapSelector:
    """__faiss_create_mask analogue: build the dense bitmap from (flag, id)
    pairs, with the sequential-id fast path of ProcessSelectionvector
    (src/faiss_extension.cpp:729-804)."""
    from .ops.bitmap import build_bitmap

    return build_bitmap(np.asarray(flags), np.asarray(ids, dtype=np.int64))


#: Selector reuse across repeated filtered calls: the reference rebuilds
#: its mask per call (src/faiss_extension.cpp:946-948 re-enters SQL every
#: time).  Repeat calls with the SAME (table, filter, idselector) are the
#: common serving pattern, so selectors are cached keyed on the Database's
#: process-unique ``uid`` and the table's registration VERSION —
#: re-registering a table invalidates automatically, and the per-index
#: mask caches (keyed on selector uid) then hit too.  The JAX package keys
#: on id(db), which CPython reuses after a Database is collected; the uid
#: cannot be reused.  A lock guards the cache against concurrent callers.
_SELECTOR_CACHE: "dict[tuple, object]" = {}
_SELECTOR_CACHE_MAX = 16
_SELECTOR_LOCK = threading.Lock()


def _cached_selector(db, tablename, filter_expr, idselector, kind: str):
    key = (db.uid, tablename, db.table_version(tablename),
           str(filter_expr), str(idselector), kind)
    with _SELECTOR_LOCK:
        sel = _SELECTOR_CACHE.get(key)
    if sel is not None:
        return sel
    if kind == "bitmap":
        flags, ids = db.eval_filter_pair(tablename, filter_expr, idselector)
        sel = create_mask(flags, ids)
    else:
        sel = SetSelector(db.eval_filter_ids(tablename, filter_expr,
                                             idselector))
    with _SELECTOR_LOCK:
        while len(_SELECTOR_CACHE) >= _SELECTOR_CACHE_MAX:
            _SELECTOR_CACHE.pop(next(iter(_SELECTOR_CACHE)))
        _SELECTOR_CACHE[key] = sel
    return sel


@_timed_op("faiss_search_filter")
def faiss_search_filter(name: str, k: int, queries, filter_expr: str,
                        idselector: str, tablename: str,
                        parameters: Mapping[str, object] | None = None,
                        catalog: Catalog | None = None,
                        database=None) -> np.ndarray:
    """faiss_search_filter — bitmap semi-join filtered search, O(n) in table
    size (SearchFunctionFilter, src/faiss_extension.cpp:927-972).  The
    reference re-enters SQL to evaluate the filter; here the two-phase plan is
    explicit: evaluate (filter, idselector) over the registered table, build
    the bitmap, then search with the mask fused into the kernel.  The
    selector (and its device mask) is reused across calls until the table
    is re-registered."""
    from .sql.engine import default_database

    db = database if database is not None else default_database()
    selector = _cached_selector(db, tablename, filter_expr, idselector,
                                "bitmap")
    return faiss_search(name, k, queries, parameters, catalog,
                        selector=selector)


@_timed_op("faiss_search_filter_set")
def faiss_search_filter_set(name: str, k: int, queries, filter_expr: str,
                            idselector: str, tablename: str,
                            parameters: Mapping[str, object] | None = None,
                            catalog: Catalog | None = None,
                            database=None) -> np.ndarray:
    """faiss_search_filter_set — id-set filtered search, O(m) in selected rows
    (SearchFunctionFilterSet, src/faiss_extension.cpp:974-1022)."""
    from .sql.engine import default_database

    db = database if database is not None else default_database()
    selector = _cached_selector(db, tablename, filter_expr, idselector,
                                "set")
    return faiss_search(name, k, queries, parameters, catalog,
                        selector=selector)


# --------------------------------------------------------------------------
# Persistence
# --------------------------------------------------------------------------

@_timed_op("faiss_save")
def faiss_save(name: str, path: str, catalog: Catalog | None = None) -> None:
    """CALL faiss_save(name, path) (src/faiss_extension.cpp:166-200)."""
    from .io.serialize import save_index

    entry = _cat(catalog).get(name)
    with entry.lock:
        save_index(entry, path)


@_timed_op("faiss_load")
def faiss_load(name: str, path: str, catalog: Catalog | None = None) -> None:
    """CALL faiss_load(name, path).  A loaded, already-trained index is
    immutable (isMutable = needs_training, src/faiss_extension.cpp:238).
    NOTE: the reference's duplicate-name guard throws the inverted message
    "Could not find index" (:228-231) — a documented quirk we do NOT copy;
    we raise the accurate "already exists" error."""
    from .io.serialize import load_index

    cat = _cat(catalog)
    entry = load_index(path)
    cat.put_new(name, entry)


# --------------------------------------------------------------------------
# Observability (no reference equivalent — SURVEY.md §5 green field)
# --------------------------------------------------------------------------

def faiss_stats(name: str | None = None,
                catalog: Catalog | None = None) -> dict:
    """Engine statistics: per-index metadata (or all indexes when name is
    None) plus accumulated per-op timings (utils/profiling)."""
    from .utils.profiling import stats as op_stats

    cat = _cat(catalog)
    names = [name] if name is not None else cat.names()
    indexes = {}
    for n in names:
        entry = cat.get(n)
        idx = entry.index
        inner = getattr(idx, "inner", idx)
        indexes[n] = {
            "factory": idx.factory_desc,
            "d": idx.d,
            "metric": idx.metric.name,
            "ntotal": idx.ntotal,
            "is_trained": idx.is_trained,
            "needs_training": entry.needs_training,
            "is_mutable": entry.is_mutable,
            "custom_labels": entry.custom_labels,
            # IVF: the list scan of the last search (per-query, pairs-flat
            # or gather) and the list count.
            "last_scan_path": getattr(inner, "_last_scan_path", None),
        }
        if hasattr(inner, "nlist"):
            indexes[n]["nlist"] = inner.nlist
    from .utils.config import config

    runtime = {
        "precision": config.precision_mode,
        "device": config.device,
    }
    return {"indexes": indexes, "ops": op_stats(), "runtime": runtime}


def faiss_search_batched(name: str, k: int, queries,
                         parameters: Mapping[str, object] | None = None,
                         batch_size: int = 256,
                         catalog: Catalog | None = None,
                         selector: Selector | None = None) -> np.ndarray:
    """Bulk search: split ``queries`` into batches, dispatch every batch to
    the device back-to-back, concatenate the device results and fetch them
    once, so the host waits for the device a single time for the whole set.

    No reference equivalent (the reference is synchronous per DuckDB
    chunk)."""
    entry = _cat(catalog).get(name)
    queries = as_matrix(queries, entry.index.d)
    params = as_params(parameters)
    k = int(k)
    if batch_size < 1:
        raise errors.InvalidInputError(
            f"batch_size must be positive, got {batch_size}")
    nq = queries.shape[0]
    if nq == 0 or k <= 0:
        return _format_results(entry.index.search(queries, k, params,
                                                  selector), k)
    index = entry.index
    disps = [index.search_dispatch(queries[s:s + batch_size], k, params,
                                   selector)
             for s in range(0, nq, batch_size)]
    if any(d is None for d in disps):
        # No device work (an empty IVF index): the sequential path pads.
        return _format_results(index.search(queries, k, params, selector),
                               k)
    big_d, big_p = fetch_results(torch.cat([d[0][:d[2]] for d in disps]),
                                 torch.cat([d[1][:d[2]] for d in disps]))
    sim = index.metric.name in SIMILARITY_METRICS
    sentinel = float("-inf") if sim else float("inf")
    parts, row = [], 0
    for disp in disps:
        nqb = disp[2]
        dist, labels, k_eff = index._map_dispatch(
            disp, big_d[row:row + nqb], big_p[row:row + nqb].astype(np.int64))
        parts.append(index._pad_result(dist, labels, nqb, k, k_eff,
                                       sentinel))
        row += nqb
    return _format_results(SearchResult(
        np.concatenate([p.distances for p in parts]),
        np.concatenate([p.labels for p in parts])), k)
