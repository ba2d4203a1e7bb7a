"""The port's DuckDB bridge (sql/duckdb_bridge.py) against the JAX
package's, the UDF bodies called with the same arrow inputs on the CPU:
equal labels and ranks, distances within 1e-5 relative (fp32 searches of
two libraries).  The duckdb-gated end-to-end case runs where the optional
duckdb package is installed, as the JAX package's does."""

import json

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

import duckdb_faiss_ext_tpu as dfx  # noqa: E402
import duckdb_faiss_ext_tpu_torch as dt  # noqa: E402
from duckdb_faiss_ext_tpu.sql import duckdb_bridge as jbridge  # noqa: E402
from duckdb_faiss_ext_tpu_torch.sql import duckdb_bridge as tbridge  # noqa

BRIDGES = (jbridge, tbridge)


@pytest.fixture(autouse=True)
def cpu_device():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


def _cleanup(*names):
    for api in (dfx, dt):
        for n in names:
            try:
                api.faiss_destroy(n)
            except Exception:
                pass


def _list_array(x: np.ndarray):
    return pa.array(list(x), pa.list_(pa.float32()))


def _assert_same_results(got, want, k):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.as_py(), w.as_py()
        assert [r["rank"] for r in g] == [r["rank"] for r in w] == list(
            range(k))
        assert [r["label"] for r in g] == [r["label"] for r in w]
        np.testing.assert_allclose([r["distance"] for r in g],
                                   [r["distance"] for r in w], rtol=1e-5,
                                   atol=1e-6)


def test_udf_bodies_match_jax():
    """create → manual_train → add_with_ids → search_params through both
    bridges' UDF bodies; an IVF4 index (every list probed, so the two
    packages' k-means do not matter)."""
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((500, 16)).astype(np.float32)
    xq = rng.standard_normal((8, 16)).astype(np.float32)
    ids = np.arange(500, dtype=np.int64) * 3
    outs = []
    try:
        for br in BRIDGES:
            assert br.udf_create("bq", 16, "IDMap,IVF4,Flat")
            assert br.udf_manual_train(_list_array(xb[:200]),
                                       pa.array(["bq"] * 200)).to_pylist() \
                == [True] * 200
            br.udf_add_with_ids(pa.array(ids), _list_array(xb),
                                pa.array(["bq"] * 500))
            outs.append(br.udf_search_params(
                pa.array(["bq"] * 8), pa.array([5] * 8), _list_array(xq),
                pa.array([json.dumps({"nprobe": "4"})] * 8)))
        _assert_same_results(outs[1], outs[0], 5)
        assert outs[1].type == outs[0].type
        ref = dt.faiss_search("bq", 5, xq, {"nprobe": "4"})
        assert [[r["label"] for r in row.as_py()] for row in outs[1]] == \
            ref["label"].tolist()
    finally:
        _cleanup("bq")


def test_udf_unlabeled_add_save_load_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    xb = rng.standard_normal((100, 8)).astype(np.float32)
    outs = []
    try:
        for side, br in zip(("jax", "torch"), BRIDGES):
            br.udf_create("bf", 8, "Flat")
            br.udf_add(_list_array(xb), pa.array(["bf"] * 100))
            out = br.udf_search(pa.array(["bf"]), pa.array([3]),
                                _list_array(xb[:4]))
            p = str(tmp_path / f"bf_{side}.dfx")
            assert br.udf_save("bf", p) and br.udf_load("bf2", p)
            again = br.udf_search(pa.array(["bf2"]), pa.array([3]),
                                  _list_array(xb[:4]))
            assert again.to_pylist() == out.to_pylist()
            assert br.udf_destroy("bf2")
            outs.append(out)
        _assert_same_results(outs[1], outs[0], 3)
        assert [row[0]["label"] for row in outs[1].to_pylist()] == [0, 1, 2,
                                                                    3]
    finally:
        _cleanup("bf", "bf2")


def test_udf_create_params_metric_matches_jax():
    try:
        for br in BRIDGES:
            br.udf_create_params("bm", 8, "HNSW16,Flat",
                                 json.dumps({"metric_type": "L2",
                                             "efConstruction": "32"}))
        assert dt.GLOBAL_CATALOG.get("bm").index.metric.name == "L2"
        assert dfx.catalog.GLOBAL_CATALOG.get("bm").index.metric.name == "L2"
    finally:
        _cleanup("bm")


@pytest.mark.parametrize("case", ["ragged", "empty", "chunked", "doubles"])
def test_vectors_from_arrow_matches_jax(case):
    if case == "ragged":
        col = pa.array([[1.0, 2.0], [3.0]], pa.list_(pa.float32()))
        for br in BRIDGES:
            with pytest.raises(ValueError, match="equal length"):
                br._vectors_from_arrow(col)
        return
    col = {"empty": pa.array([], pa.list_(pa.float32())),
           "chunked": pa.chunked_array([_list_array(
               np.arange(6, dtype=np.float32).reshape(2, 3))]),
           "doubles": pa.array([[0.5, 1.5], [2.5, 3.5]],
                               pa.list_(pa.float64()))}[case]
    got, want = (br._vectors_from_arrow(col) for br in (tbridge, jbridge))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_results_to_arrow_matches_jax():
    res = np.zeros((2, 3), dtype=dt.RESULT_DTYPE)
    res["rank"] = np.arange(3)
    res["label"] = [[5, -1, 7], [1, 2, 3]]
    res["distance"] = [[0.5, np.inf, 1.0], [2.0, 3.0, 4.0]]
    got = tbridge._results_to_arrow(res)
    want = jbridge._results_to_arrow(res)
    assert got.equals(want)


def test_duckdb_end_to_end():
    """The reference's client pattern through a real duckdb.connect()
    (runs wherever the optional duckdb package is installed)."""
    duckdb = pytest.importorskip("duckdb")
    rng = np.random.default_rng(6)
    xb = rng.standard_normal((300, 12)).astype(np.float32)
    con = duckdb.connect()
    try:
        dt.sql.register_duckdb(con)
        con.execute("CREATE TABLE t AS SELECT * FROM (SELECT "
                    "row_number() OVER () - 1 AS id, emb FROM "
                    "(SELECT unnest(?) AS emb))", [list(map(list, xb))])
        assert con.execute(
            "SELECT faiss_create('dk', 12, 'IDMap,Flat')").fetchone()[0]
        con.execute("SELECT faiss_add_with_ids(id, emb, 'dk') FROM t")
        rows = con.execute(
            "SELECT UNNEST(faiss_search('dk', 3, emb)).label FROM t "
            "LIMIT 3").fetchall()
        assert rows[0][0] == 0                         # self-hit
        res = tbridge.filtered_search(con, "dk", 3, xb[:4], "id % 2 = 0",
                                      "id", "t")
        assert np.all(res["label"][res["label"] >= 0] % 2 == 0)
    finally:
        _cleanup("dk")
        con.close()
