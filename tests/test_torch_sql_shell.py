"""The port's SQL tier, shell and bench against the JAX package's.

* ``sql.dispatch.connect()``: the statement shapes of
  tests/test_sql_dispatch.py through both packages' connections give
  equal rows (labels equal wherever the distances are apart, distances
  within 1e-5 of the larger of the largest |distance| and ‖q‖²), the
  JAX package's HNSW statements as they are (1,000 rows: the exact
  regime); an IVF searched at nprobe = nlist is exhaustive, so its rows do
  not depend on the packages' centroids;
* the placement routes (``faiss_to_gpu`` / ``faiss_to_device`` /
  ``faiss_move_gpu``, with and without a device index) place the index in
  both packages and leave its search rows as they were
  (``faiss_range_search`` answers: tests/test_torch_range_search.py);
* ``python -m duckdb_faiss_ext_tpu_torch`` driven through stdin
  reproduces the reference's golden distances, and without ``--cpu`` on a
  machine with no card reports the device error and keeps running;
* ``sql.logictest.run_file`` runs a small .test file (the reference's
  golden statements over tests/data) as the JAX package's runner does;
* ``python3 -m duckdb_faiss_ext_tpu_torch.bench`` at a tiny size on the
  CPU prints one JSON line with bench.py's keys plus ``cpu_qps``, and
  without ``--cpu`` on a machine with no card fails instead of running on
  the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.sql import logictest as jlogic
from duckdb_faiss_ext_tpu.sql.dispatch import connect as jconnect
from duckdb_faiss_ext_tpu_torch import bench
from duckdb_faiss_ext_tpu_torch.sql import logictest as plogic
from duckdb_faiss_ext_tpu_torch.sql.dispatch import connect as pconnect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

#: the reference's golden results (test/sql/faiss.test:16-38 and
#: faiss3.test:22-45): rank-0 / rank-1 inner products and labels
GOLDEN_DISTANCES = [
    2.3337207, 2.2165565, 3.5882926, 3.336133, 4.2489142, 4.133893,
    3.3984408, 3.1702023, 2.8143706, 2.7383637, 3.7191334, 3.6072645,
    2.866281, 2.8265002, 4.5306416, 4.3778625, 4.809322, 4.7254314,
    5.233301, 5.0149097]
GOLDEN_LABELS = [374, 59, 374, 676, 768, 880, 374, 623, 374, 623, 59, 880,
                 999, 904, 374, 676, 880, 955, 943, 374]


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


def _connections():
    """A JAX and a port connection over the same registered tables."""
    rng = np.random.default_rng(77)
    xb = rng.random((1000, 8), dtype=np.float32)
    xq = rng.random((10, 8), dtype=np.float32)
    flags = (np.arange(1, 1001) % 2 == 0).astype(np.uint8)
    cons = []
    for mod, connect in ((dfx, jconnect), (dt, pconnect)):
        con = connect(database=mod.Database())
        con.register("input", {"id": np.arange(1, 1001), "data": xb})
        con.register("queries", {"id": np.arange(1, 11), "data": xq})
        con.register("flags", {"flag": flags, "id": np.arange(1, 1001)})
        cons.append(con)
    return cons, xq


#: statement scripts of tests/test_sql_dispatch.py; each script's SELECTs
#: are compared row by row
SCRIPTS = {
    "readme_workflow": [
        "CALL FAISS_CREATE('name', 8, 'IDMap,HNSW32')",
        "CALL FAISS_ADD((SELECT id, data FROM input), 'name')",
        "SELECT id, UNNEST(FAISS_SEARCH('name', 10, data)) FROM queries",
        "SELECT id, UNNEST(FAISS_SEARCH_FILTER('name', 10, data, "
        "'id%2==0', 'id', 'input')) FROM queries"],
    "create_with_metric_and_params": [
        "CALL faiss_create('flat8', 8, 'Flat', metric_type='L2')",
        "CALL faiss_create_params('hnsw16', 8, 'HNSW16', "
        "map{'efConstruction': 32}, metric_type='INNER_PRODUCT')",
        "CALL faiss_add((SELECT data FROM input), 'flat8')",
        "CALL faiss_add((SELECT data FROM input), 'hnsw16')",
        "SELECT faiss_search('flat8', 2, data) FROM queries",
        "SELECT faiss_search('hnsw16', 3, data, map{'efSearch': 64}) "
        "FROM queries"],
    "manual_train_and_destroy": [
        "CALL faiss_create('mt', 8, 'IVF4,Flat', metric_type='L2')",
        "CALL faiss_manual_train((SELECT data FROM input), 'mt')",
        "CALL faiss_add((SELECT data FROM input), 'mt')",
        "SELECT UNNEST(faiss_search('mt', 3, data, map{'nprobe': 4})) "
        "FROM queries",
        "CALL faiss_destroy('mt')"],
    "filter_set": [
        "CALL faiss_create('fs', 8, 'IDMap,Flat')",
        "CALL faiss_add((SELECT id, data FROM input), 'fs')",
        "SELECT UNNEST(faiss_search_filter_set('fs', 5, data, 'id>500', "
        "'id', 'input')) FROM queries"],
    "literal_query_vector": [
        "CALL faiss_create('lit', 8, 'Flat', metric_type='L2')",
        "CALL faiss_add((SELECT data FROM input), 'lit')",
        "SELECT UNNEST(faiss_search('lit', 2, "
        "[0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])) FROM queries"],
    "create_mask": [
        "CALL faiss_create('cm', 8, 'IDMap,Flat')",
        "CALL faiss_add((SELECT id, data FROM input), 'cm')",
        "CALL __faiss_create_mask((SELECT flag, id FROM flags), 'even')"],
    "sq_families": [
        "CALL faiss_create('s8', 8, 'IDMap,SQ8', metric_type='L2')",
        "CALL faiss_add((SELECT id, data FROM input), 's8')",
        "SELECT id, UNNEST(faiss_search('s8', 4, data)) FROM queries",
        "CALL faiss_create('bf', 8, 'SQbf16')",
        "CALL faiss_add((SELECT data FROM input), 'bf')",
        "SELECT faiss_search('bf', 4, data) FROM queries"],
}


def _rows_as_arrays(rows, nq):
    """(labels, distances) (nq, k) and the other columns of a SELECT's row
    dicts over the nq-row queries table."""
    if rows and "result" in rows[0]:
        labels = np.stack([r["result"]["label"] for r in rows])
        dist = np.stack([r["result"]["distance"] for r in rows])
    else:
        labels = np.array([r["label"] for r in rows]).reshape(nq, -1)
        dist = np.array([r["distance"] for r in rows],
                        np.float32).reshape(nq, -1)
    other = [{c: v for c, v in r.items()
              if c not in ("result", "label", "distance")} for r in rows]
    return labels, dist, other


def _assert_rows_agree(got, want, xq):
    gl, gd, go = _rows_as_arrays(got, xq.shape[0])
    wl, wd, wo = _rows_as_arrays(want, xq.shape[0])
    assert go == wo
    tol = 1e-5 * max(float(np.abs(wd).max()), float((xq * xq).sum(1).max()))
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=tol)
    gap = np.abs(np.diff(wd, axis=1)) > 2 * tol
    sep = np.ones_like(wl, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(gl[sep], wl[sep])


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_statements_match_jax(script):
    (jcon, pcon), xq = _connections()
    for sql in SCRIPTS[script]:
        want, got = jcon.execute(sql), pcon.execute(sql)
        if sql.lstrip().upper().startswith("SELECT"):
            assert len(got) == len(want)
            _assert_rows_agree(got, want, xq)
        else:
            assert got is None and want is None
    assert sorted(jcon.catalog.names()) == sorted(pcon.catalog.names())
    assert sorted(jcon.masks) == sorted(pcon.masks)
    if script == "create_mask":
        sel = pcon.masks["even"]
        res = dt.faiss_search("cm", 5, xq, catalog=pcon.catalog,
                              selector=sel)
        got = res["label"][res["label"] >= 0]
        assert got.size and (got % 2 == 0).all()
    elif script == "readme_workflow":
        labels = [r["label"] for r in pcon.execute(SCRIPTS[script][-1])]
        assert labels and all(lab % 2 == 0 for lab in labels)


def test_save_load_via_sql(tmp_path):
    (_, con), _ = _connections()
    p = str(tmp_path / "i.dfx")
    con.execute("CALL faiss_create('s', 8, 'SQ4', metric_type='L2')")
    con.execute("CALL faiss_add((SELECT data FROM input), 's')")
    con.execute(f"CALL faiss_save('s', '{p}')")
    con.execute(f"CALL faiss_load('s2', '{p}')")
    a = con.execute("SELECT faiss_search('s', 2, data) FROM queries")
    b = con.execute("SELECT faiss_search('s2', 2, data) FROM queries")
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra["result"], rb["result"])


@pytest.mark.parametrize("sql,match", [
    ("CALL faiss_create('flat8', 8, 'Flat', metric_type='Invalid')",
     "Unknown metric type: Invalid"),
    ("DROP TABLE input", "Cannot parse"),
    ("SELECT faiss_search('missing', 3, data) FROM queries", "Could not find"),
    ("CALL faiss_create('x', 8, 'Flat', map{'a': 1})",
     "faiss_create takes 3 positional arguments"),
])
def test_errors_match_jax(sql, match):
    (jcon, pcon), _ = _connections()
    msgs = []
    for con, mod in ((jcon, dfx), (pcon, dt)):
        with pytest.raises(mod.InvalidInputError, match=match) as exc:
            con.execute(sql)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("sql,what", [
    ("CALL faiss_to_gpu('f')", "faiss_to_gpu"),
    ("CALL faiss_to_device('f', 0)", "faiss_to_device"),
    ("CALL faiss_move_gpu('f')", "faiss_move_gpu"),
    ("CALL faiss_to_device('f')", "faiss_to_device"),
])
def test_unported_routes_not_yet_available(sql, what):
    """The placement routes, once waiting for a later part of the port,
    now place the index in both packages: the port's Flat buffer becomes
    row blocks over one device, and the search rows stay equal to the JAX
    package's."""
    conns, xq = _connections()
    rows = []
    search = "SELECT faiss_search('f', 3, data) FROM queries"
    for con in conns:
        con.execute("CALL faiss_create('f', 8, 'Flat', metric_type='L2')")
        con.execute("CALL faiss_add((SELECT data FROM input), 'f')")
        before = con.execute(search)
        assert con.execute(sql) is None, what
        rows.append(con.execute(search))
        _assert_rows_agree(rows[-1], before, xq)
    assert conns[1].catalog.get("f").index._placement is not None
    _assert_rows_agree(rows[1], rows[0], xq)


def _shell(stdin, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "duckdb_faiss_ext_tpu_torch", *args],
        input=stdin, capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120)


def test_shell_through_stdin():
    """The shell reproduces the reference's golden IDMap,Flat results from
    its test corpus and keeps running after an error."""
    out = _shell("\n".join([
        ".help",
        f".read_csv training {DATA}/training.csv",
        f".read_csv queries {DATA}/queries.csv",
        "CALL faiss_create('g', 8, 'IDMap,Flat')",
        "CALL faiss_add((SELECT id, data FROM training), 'g')",
        "CALL faiss_to_gpu('g')",
        "SELECT UNNEST(faiss_search('g', 2, data)) FROM queries",
        "SELECT faiss_range_search('g', 4.5, data) FROM queries",
        ".tables", ".indexes", ".stats", ".nonsense", ".quit"]) + "\n",
        "--cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("duckdb_faiss_ext_tpu_torch shell")
    rows = [eval(ln.removeprefix("D ")) for ln in lines
            if "'rank'" in ln]
    assert [r["label"] for r in rows] == GOLDEN_LABELS
    np.testing.assert_allclose([r["distance"] for r in rows],
                               GOLDEN_DISTANCES, rtol=2e-6)
    text = out.stdout
    assert "registered table training: 1000 rows, vector dim 8" in text
    # The range route prints one row per (query, label, distance): those of
    # the API on the same corpus.
    ranged = [eval(ln.removeprefix("D ")) for ln in lines
              if "'query'" in ln]
    raw = np.loadtxt(f"{DATA}/training.csv", delimiter=",")
    qs = np.loadtxt(f"{DATA}/queries.csv", delimiter=",")[:, 1:]
    pcat = dt.Catalog()
    dt.faiss_create("g", 8, "IDMap,Flat", catalog=pcat)
    dt.faiss_add((raw[:, 0].astype(np.int64), raw[:, 1:].astype(np.float32)),
                 "g", catalog=pcat)
    want = dt.faiss_range_search("g", 4.5, qs.astype(np.float32),
                                 catalog=pcat)
    assert 0 < len(ranged) == want["lims"][-1]
    assert [(r["query"], r["label"]) for r in ranged] == [
        (q, int(lab)) for q in range(10)
        for lab in want["label"][want["lims"][q]:want["lims"][q + 1]]]
    # faiss_to_gpu placed the index before the searches above.
    assert "Invalid Input Error: faiss_to_gpu" not in text
    assert "['queries', 'training']" in text and "['g']" in text
    assert '"faiss_search"' in text and "unknown command .nonsense" in text
    assert "python -m duckdb_faiss_ext_tpu_torch" in text


def test_shell_without_a_card_reports_the_device_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _shell("CALL faiss_create('g', 8, 'Flat')\n.indexes\n")
    assert out.returncode == 0, out.stderr
    assert "torch.cuda.is_available() is False" in out.stdout
    assert "[]" in out.stdout


GOLDEN_TEST = """\
require faiss

statement ok
CALL faiss_create('flat8', 8, 'IDMap,Flat');

statement ok
CALL faiss_add((SELECT column0, list_value(column1, column2, column3, \
column4, column5, column6, column7, column8) FROM 'training.csv'), 'flat8');

statement error
CALL faiss_create('flat8', 8, 'Flat');
----
Invalid Input Error: Index flat8 already exists.

statement error
CALL faiss_create('bad', 8, 'Flat', metric_type='Invalid');
----
Invalid Input Error: Unknown metric type: Invalid

query III
SELECT UNNEST(faiss_search('flat8', 2, list_value(column1, column2, \
column3, column4, column5, column6, column7, column8)), recursive:=true) \
FROM 'queries.csv';
----
{rows}

statement ok
CALL faiss_destroy('flat8');
"""


def test_logictest_run_file_matches_jax(tmp_path):
    rows = "\n".join(f"{i % 2}\t{lab}\t{dist}" for i, (lab, dist) in
                     enumerate(zip(GOLDEN_LABELS, GOLDEN_DISTANCES)))
    path = tmp_path / "golden.test"
    path.write_text(GOLDEN_TEST.format(rows=rows))
    got = plogic.run_file(str(path), DATA)
    want = jlogic.run_file(str(path), DATA)
    assert got == want
    assert [kind for _, kind, _ in got] == [
        "statement_ok", "statement_ok", "statement_error",
        "statement_error", "query", "statement_ok"]
    assert all(fail is None for _, _, fail in got), got


def test_logictest_reports_a_wrong_golden(tmp_path):
    rows = "\n".join(f"{i % 2}\t{lab + 1}\t{dist}" for i, (lab, dist) in
                     enumerate(zip(GOLDEN_LABELS, GOLDEN_DISTANCES)))
    path = tmp_path / "wrong.test"
    path.write_text(GOLDEN_TEST.format(rows=rows))
    got = plogic.run_file(str(path), DATA)
    assert got == jlogic.run_file(str(path), DATA)
    assert [fail is not None for _, _, fail in got] == [
        False, False, False, False, True, False]


def test_bench_main_prints_one_json_line(monkeypatch, capsys):
    """The port bench at a tiny size on the CPU: one JSON line on stdout
    with bench.py's keys, plus the raw CPU denominator."""
    monkeypatch.setattr(bench, "BIG_BATCH", 64)
    monkeypatch.setattr(bench, "PIPELINE", 2)
    try:
        assert bench.main(["--cpu", "--n", "2048"]) == 0
    finally:
        dt.set_precision("parity")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    for key in ("metric", "value", "unit", "vs_baseline", "pipelined_qps",
                "ivf_qps", "ivf_qps_b1024", "ivf_recall", "cpu_qps"):
        assert key in line, key
    assert line["metric"] == "flat_search_qps_sift1m_k10_b48"
    assert line["device"] == "cpu" and line["card"] is None
    assert line["n"] == 2048 and line["ivf_recall"] == 1.0
    assert line["vs_baseline"] == pytest.approx(line["value"]
                                                / line["cpu_qps"])
    assert all(line[k] > 0 for k in ("value", "pipelined_qps", "ivf_qps",
                                     "cpu_qps"))


def test_bench_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    dt.config.device = "cuda"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.run(256)
