"""DuckDB bridge: the faiss_* surface as DuckDB Python UDFs.

The reference is a DuckDB loadable extension; its clients issue SQL like

    CALL FAISS_CREATE('flat', 768, 'IDMap,Flat')
    CALL FAISS_ADD((SELECT id, emb FROM t), 'flat')
    SELECT UNNEST(FAISS_SEARCH('flat', 5, emb)).label FROM queries

(the reference's examples/ai.py, go/helper.go:9-19).  This module
registers the same surface on a real ``duckdb.connect()`` connection so
those client patterns run against the port, with one structural
difference: the
DuckDB Python API exposes scalar functions only (no table functions), so
the CALL forms become scalar invocations driven by a query —

    SELECT faiss_create('flat', 768, 'IDMap,Flat')
    SELECT faiss_add(id, emb, 'flat') FROM t          -- streaming chunks
    SELECT UNNEST(faiss_search('flat', 5, emb)).label FROM queries

``faiss_search``/``faiss_add`` are vectorized (arrow) UDFs: DuckDB hands
them whole chunks, matching the reference's per-chunk table-function
execution (src/faiss_extension.cpp:475-547, 903-925); the search returns
the reference's exact result shape LIST(STRUCT(rank INT, label BIGINT,
distance FLOAT)) padded to k with label -1.

Filtered search re-enters SQL in the reference (a second Connection to the
same database runs the synthesized mask query, src/faiss_extension.cpp:
946-948).  Here ``filtered_search(con, ...)`` reproduces that two-phase
plan explicitly: it runs the synthesized ``SELECT CAST(<filter> AS
UTINYINT), CAST(<idsel> AS BIGINT) FROM <table>`` on a cursor of the same
connection, builds the bitmap through the native builder, and searches
with the selector fused into the kernel.

The UDF bodies are plain pyarrow→pyarrow functions (unit-testable without
duckdb); ``register(con)`` binds them to a connection.  ``pyarrow`` and
``duckdb`` are imported at first use only: the package imports and serves
without them.

A copy of ``duckdb_faiss_ext_tpu/sql/duckdb_bridge.py`` over the port's
API: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json

import numpy as np

from .. import api
from ..params import as_params


def _pa():
    import pyarrow

    return pyarrow


RESULT_STRUCT_SQL = "STRUCT(rank INTEGER, label BIGINT, distance FLOAT)[]"


def _vectors_from_arrow(col) -> np.ndarray:
    """LIST(FLOAT/DOUBLE) arrow column → (n, d) fp32 matrix."""
    pa = _pa()
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    lst = col.values.to_numpy(zero_copy_only=False).astype(np.float32)
    offsets = col.offsets.to_numpy(zero_copy_only=False)
    widths = np.diff(offsets)
    if widths.size == 0:
        return np.empty((0, 0), np.float32)
    d = int(widths[0])
    if not (widths == d).all():
        raise ValueError("all vectors in a chunk must have equal length")
    start, stop = int(offsets[0]), int(offsets[-1])
    return lst[start:stop].reshape(-1, d)


def _scalar(col):
    """First value of a constant arrow column (name / k arguments)."""
    pa = _pa()
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    return col[0].as_py()


def _results_to_arrow(res: np.ndarray):
    """(nq, k) structured results → arrow LIST(STRUCT(rank,label,distance))."""
    pa = _pa()
    nq, k = res.shape
    struct = pa.StructArray.from_arrays(
        [pa.array(res["rank"].reshape(-1), pa.int32()),
         pa.array(res["label"].reshape(-1), pa.int64()),
         pa.array(res["distance"].reshape(-1), pa.float32())],
        names=["rank", "label", "distance"])
    offsets = pa.array(np.arange(0, (nq + 1) * k, k, dtype=np.int32))
    return pa.ListArray.from_arrays(offsets, struct)


# --------------------------------------------------------------------------
# UDF bodies (pyarrow in, pyarrow out — unit-tested without duckdb)
# --------------------------------------------------------------------------

def udf_search(names, ks, vecs):
    name, k = _scalar(names), int(_scalar(ks))
    q = _vectors_from_arrow(vecs)
    res = api.faiss_search(name, k, q)
    return _results_to_arrow(res)


def udf_search_params(names, ks, vecs, params_json):
    name, k = _scalar(names), int(_scalar(ks))
    params = json.loads(_scalar(params_json) or "{}")
    q = _vectors_from_arrow(vecs)
    res = api.faiss_search(name, k, q, params)
    return _results_to_arrow(res)


def udf_add(vecs, names):
    pa = _pa()
    name = _scalar(names)
    x = _vectors_from_arrow(vecs)
    api.faiss_add(x, name)
    return pa.array(np.ones((len(vecs),), bool))


def udf_add_with_ids(ids, vecs, names):
    pa = _pa()
    name = _scalar(names)
    if isinstance(ids, pa.ChunkedArray):
        ids = ids.combine_chunks()
    labels = ids.to_numpy(zero_copy_only=False).astype(np.int64)
    x = _vectors_from_arrow(vecs)
    api.faiss_add((labels, x), name)
    return pa.array(np.ones((len(vecs),), bool))


def udf_manual_train(vecs, names):
    pa = _pa()
    name = _scalar(names)
    x = _vectors_from_arrow(vecs)
    api.faiss_manual_train(x, name)
    return pa.array(np.ones((len(vecs),), bool))


def udf_create(name: str, dimension: int, index_type: str) -> bool:
    api.faiss_create(name, int(dimension), index_type)
    return True


def udf_create_params(name: str, dimension: int, index_type: str,
                      params_json: str) -> bool:
    params = json.loads(params_json or "{}")
    metric = params.pop("metric_type", None)
    kwargs = {"metric_type": metric} if metric else {}
    api.faiss_create_params(name, int(dimension), index_type,
                            {str(k): str(v) for k, v in params.items()},
                            **kwargs)
    return True


def udf_destroy(name: str) -> bool:
    api.faiss_destroy(name)
    return True


def udf_save(name: str, path: str) -> bool:
    api.faiss_save(name, path)
    return True


def udf_load(name: str, path: str) -> bool:
    api.faiss_load(name, path)
    return True


# --------------------------------------------------------------------------
# Filtered search: the reference's re-entrant two-phase plan, explicit
# --------------------------------------------------------------------------

def filtered_search(con, name: str, k: int, queries, filter_expr: str,
                    idselector: str, tablename: str,
                    parameters=None):
    """faiss_search_filter over a DuckDB connection: synthesizes the mask
    query the reference synthesizes (src/faiss_extension.cpp:939-944),
    executes it on a cursor of the same database, builds the dense bitmap
    with the native builder, and runs the selector-fused search."""
    from ..ops.bitmap import build_bitmap

    cur = con.cursor()
    flags, ids = cur.execute(
        f"SELECT CAST(({filter_expr}) AS UTINYINT), "
        f"CAST(({idselector}) AS BIGINT) FROM {tablename}").fetchnumpy(). \
        values()
    selector = build_bitmap(np.asarray(flags, np.uint8),
                            np.asarray(ids, np.int64))
    return api.faiss_search(name, int(k), queries,
                            as_params(parameters), selector=selector)


def filtered_search_set(con, name: str, k: int, queries, filter_expr: str,
                        idselector: str, tablename: str,
                        parameters=None):
    """faiss_search_filter_set: O(m) id-set selector built from the
    synthesized WHERE query (src/faiss_extension.cpp:986-1008)."""
    from ..ops.selectors import SetSelector

    cur = con.cursor()
    ids = cur.execute(
        f"SELECT CAST(({idselector}) AS BIGINT) FROM {tablename} "
        f"WHERE {filter_expr}").fetchnumpy()
    ids = next(iter(ids.values()))
    selector = SetSelector(np.asarray(ids, np.int64))
    return api.faiss_search(name, int(k), queries,
                            as_params(parameters), selector=selector)


# --------------------------------------------------------------------------
# Registration
# --------------------------------------------------------------------------

def register(con) -> None:
    """Register the faiss_* functions on a duckdb connection (the
    LoadInternal analogue, src/faiss_extension.cpp:1025-1149)."""
    import duckdb
    from duckdb.typing import BIGINT, BOOLEAN, VARCHAR

    flt_list = duckdb.list_type("FLOAT")
    result_t = duckdb.dtype(RESULT_STRUCT_SQL)

    con.create_function("faiss_create", udf_create,
                        [VARCHAR, BIGINT, VARCHAR], BOOLEAN)
    con.create_function("faiss_create_params", udf_create_params,
                        [VARCHAR, BIGINT, VARCHAR, VARCHAR], BOOLEAN)
    con.create_function("faiss_destroy", udf_destroy, [VARCHAR], BOOLEAN)
    con.create_function("faiss_save", udf_save, [VARCHAR, VARCHAR], BOOLEAN)
    con.create_function("faiss_load", udf_load, [VARCHAR, VARCHAR], BOOLEAN)
    con.create_function("faiss_add", udf_add, [flt_list, VARCHAR], BOOLEAN,
                        type="arrow")
    con.create_function("faiss_add_with_ids", udf_add_with_ids,
                        [BIGINT, flt_list, VARCHAR], BOOLEAN, type="arrow")
    con.create_function("faiss_manual_train", udf_manual_train,
                        [flt_list, VARCHAR], BOOLEAN, type="arrow")
    con.create_function("faiss_search", udf_search,
                        [VARCHAR, BIGINT, flt_list], result_t, type="arrow")
    con.create_function("faiss_search_params", udf_search_params,
                        [VARCHAR, BIGINT, flt_list, VARCHAR], result_t,
                        type="arrow")
