"""The port's measured pairs gate (duckdb_faiss_ext_tpu_torch/ops/pairs_gate.py)
against the JAX package's (duckdb_faiss_ext_tpu/ops/pairs_gate.py).

* ``pairs_speedup_estimate`` and ``pairs_preferred`` equal the JAX functions
  exactly (the same floats, the same decisions) when both get the same
  table: the JAX package's rows measured on its TPU and the port's rows
  measured on the H100, over a grid of (lmax*d, nq, d) and static rules.
* The port's rows reproduce themselves (the interpolation at a measured
  point is that point's ratio within 5%), and its floors and the static
  fallback outside the hull act as the JAX gate's.
* ``IVFServe.pairs_wanted`` decides through the gate with the static rule as
  its fallback, for Flat and SQ8 lists, and keeps its two overrides.
* The measuring sweep (``tools/pairs_crossover.py``) runs with ``--cpu`` at a
  tiny grid and prints rows in the table's format (without ``--cpu`` and
  with no card it raises: tests/test_torch_bench_tools.py).
"""

import itertools
import re

import pytest
import torch

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.ops import pairs_gate as jax_gate
from duckdb_faiss_ext_tpu_torch.factory import build_index
from duckdb_faiss_ext_tpu_torch.metrics import resolve_metric
from duckdb_faiss_ext_tpu_torch.ops import pairs_gate as gate
from duckdb_faiss_ext_tpu_torch.tools import pairs_crossover

WORKS = (1 << 10, 1 << 16, 3 << 16, 1 << 19, 786432, 3145728, 3932160,
         1 << 24, 1 << 30)
NQS = (1, 63, 64, 100, 256, 512, 1000, 1024, 4096, 1 << 20)
DS = (0, 16, 128, 768, 1536)
TABLES = {"jax": jax_gate.MEASURED, "port": gate.MEASURED}


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The CPU, on one torch thread: the test workers share the cores."""
    prev, threads = dt.config.device, torch.get_num_threads()
    dt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    dt.config.device = prev


@pytest.mark.parametrize("table", sorted(TABLES))
def test_estimate_equals_jax(table):
    rows = TABLES[table]
    for work, nq, d in itertools.product(WORKS, NQS, DS):
        assert gate.pairs_speedup_estimate(work, nq, d, rows) \
            == jax_gate.pairs_speedup_estimate(work, nq, d, rows)


@pytest.mark.parametrize("static", [None, True, False])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_decision_equals_jax(table, static):
    rows = TABLES[table]
    for work, nq, d in itertools.product(WORKS, NQS, DS):
        assert gate.pairs_preferred(work, nq, d, table=rows,
                                    static_ok=static) \
            == jax_gate.pairs_preferred(work, nq, d, table=rows,
                                        static_ok=static)


def test_empty_table_is_the_static_rule():
    for work, nq in itertools.product(WORKS, NQS):
        static = work >= (1 << 19) and nq >= 256
        floors = nq >= gate.MIN_BATCH_FLOOR and work >= gate.MIN_WORK_FLOOR
        assert gate.pairs_speedup_estimate(work, nq, 128, []) \
            == (1.0, float("inf"))
        assert gate.pairs_preferred(work, nq, 128, table=[]) \
            == (static and floors) \
            == jax_gate.pairs_preferred(work, nq, 128, table=[])


def test_port_rows_are_the_h100_grid():
    """14 rows at the JAX grid's points, each ratio positive."""
    assert len(gate.MEASURED) == 14
    grid = {(w, n, d) for w, n, d, _ in jax_gate.MEASURED}
    assert {(w, n, d) for w, n, d, _ in gate.MEASURED} == grid
    assert all(s > 0 for *_, s in gate.MEASURED)


@pytest.mark.parametrize("row", gate.MEASURED, ids=str)
def test_rows_reproduce_themselves(row):
    work, nq, d, ratio = row
    est, dist = gate.pairs_speedup_estimate(work, nq, d)
    assert dist == 0.0
    assert abs(est - ratio) / ratio < 0.05
    assert gate.pairs_preferred(work, nq, d) == (est >= 1.05)


def test_floors_bind():
    assert not gate.pairs_preferred(1 << 30, gate.MIN_BATCH_FLOOR - 1,
                                    static_ok=True)
    assert not gate.pairs_preferred(gate.MIN_WORK_FLOOR - 1, 4096,
                                    static_ok=True)
    assert not jax_gate.pairs_preferred(1 << 30, 8)
    assert not jax_gate.pairs_preferred(1 << 10, 4096)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_static_rule_outside_hull(table):
    rows = TABLES[table]
    far = max(w for w, *_ in rows) * 1024
    for static in (True, False):
        assert gate.pairs_preferred(far, 1 << 20, table=rows,
                                    static_ok=static) is static
        assert jax_gate.pairs_preferred(far, 1 << 20, table=rows,
                                        static_ok=static) is static


def test_marco_b48_lies_outside_the_hull():
    """The marco shape (lmax 2560, d 1536) at b48 padded to 64 rows is just
    over 2 octaves from the nearest row, so the static rule decides (the
    per-query search); at b1024 the rows decide (the pair tiles)."""
    work = 2560 * 1536
    est, dist = gate.pairs_speedup_estimate(work, 64, 1536)
    assert 2.0 < dist < 2.1
    assert not gate.pairs_preferred(work, 64, 1536, static_ok=False)
    est, dist = gate.pairs_speedup_estimate(work, 1024, 1536)
    assert dist < 0.5 and est >= 1.05


@pytest.mark.parametrize("factory,d", [("IVF4,Flat", 128), ("IVF4,SQ8", 128),
                                       ("IVF4,SQ8", 1536),
                                       ("IVF4,Flat", 768)])
def test_pairs_wanted_decides_through_the_gate(factory, d):
    index = build_index(d, factory, resolve_metric("INNER_PRODUCT"))
    for lmax, nq in itertools.product((64, 512, 1024, 2048, 2560, 4096),
                                      (1, 64, 128, 256, 512, 1024, 4096)):
        work = lmax * d
        static = nq >= 256 and work >= (1 << 19)
        assert index.pairs_wanted(nq, lmax) == jax_gate.pairs_preferred(
            work, nq, d, table=gate.MEASURED, static_ok=static)


def test_pairs_wanted_overrides():
    """PAIRS_MIN_BATCH above 2**20 forces the per-query search;
    PAIRS_MIN_WORK == 0 forces the pair tiles from PAIRS_MIN_BATCH
    queries, whatever the rows say."""
    index = build_index(128, "IVF4,Flat", resolve_metric("L2"))
    assert not index.pairs_wanted(1024, 512)       # the rows: 0.41
    index.PAIRS_MIN_WORK = 0
    assert index.pairs_wanted(1024, 512) and index.pairs_wanted(256, 8)
    assert not index.pairs_wanted(255, 8)
    index.PAIRS_MIN_BATCH = 1
    assert index.pairs_wanted(1, 1)
    index.PAIRS_MIN_BATCH = 10 ** 9
    assert not index.pairs_wanted(1 << 20, 2560)
    wide = build_index(1536, "IVF4,SQ8", resolve_metric("L2"))
    assert wide.pairs_wanted(1024, 2560)
    wide.PAIRS_MIN_BATCH = 10 ** 9
    assert not wide.pairs_wanted(1024, 2560)


def test_crossover_tool_cpu(capsys):
    assert pairs_crossover.main(["--cpu", "--grid", "32:16,64:32", "--nqs",
                                 "64,128", "--nlist", "16", "--nprobe", "4",
                                 "--reps", "2", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^    \((\d+), (\d+), (\d+), ([\d.]+)\),$", out, re.M)
    assert [tuple(int(v) for v in r[:3]) for r in rows] == [
        (512, 64, 16), (512, 128, 16), (2048, 64, 32), (2048, 128, 32)]
    assert all(float(r[3]) > 0 for r in rows)
    assert len(re.findall(r"per-query \(K2\) [\d.]+ ms, pair tiles \(K3\)",
                          out)) == 4
    assert out.rstrip().endswith("PAIRS-CROSSOVER COMPLETE")
    assert pairs_crossover.main(["--cpu", "--flat", "--grid", "32:16",
                                 "--nqs", "64", "--nlist", "8", "--nprobe",
                                 "2", "--reps", "1"]) == 0
    assert "per-query (K6)" in capsys.readouterr().out
