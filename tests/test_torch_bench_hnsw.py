"""The benchmark's HNSW family (``hnsw``: the upstream's HNSW benchmark
index, ``benchmark/configs/marco-idmap-hnsw128-flat.json``) driven at a
small size on the CPU: the system through the port's public API, the plain
reference against numpy, the work count by hand, the cell's run, and the
comparison turning ``correct`` false for each fault the cell can have (a
label altered, distances in TF32, a row twice in an answer, FAISS's default
efSearch 16, a graph with its reverse edges dropped) and for the control
(TF32 products).

The faults are judged on one clustered build (``graph_max`` lowered, as
the 8.8M-row index is past it) at 20,000 x 32 with degree 16, where a walk
at efSearch 16 misses what one at 64 finds; its limits for ``recall_miss``
and ``unreachable`` lie between the readings there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_faiss_ext_tpu_torch.models.hnsw import HNSWIndex
from duckdb_faiss_ext_tpu_torch.ops import graph as graph_ops

from benchmark import compare, control, control_hnsw, harness
from benchmark.reference import hnsw as ref
from benchmark.reference.common import to_tf32
from benchmark.work import hnsw as work

CELL = "marco-hnsw128-b48"
#: the configuration as the faults are judged: 20,000 x 32, degree 16
FAULTS = {"rows": 20000, "d": 32, "chunk_rows": 4096, "centers": 4096,
          "ann_threshold": 1000, "factory": "IDMap,HNSW8,Flat",
          "graph_degree": 16}
#: the limits there: recall_miss between the walk at efSearch 64 (0.025)
#: and at 16 (0.083); unreachable between the clustered rule (0) and the
#: forward-only prune
FAULT_LIMITS = {"recall_miss": 0.05, "unreachable": 0.001}
#: the configuration at a small size as one cell run takes it
SMALL = {"rows": 20000, "d": 64, "chunk_rows": 4096, "centers": 256,
         "ann_threshold": 1000, "factory": "IDMap,HNSW32,Flat",
         "graph_degree": 64}
#: the recall the small cell's walk holds at least
RECALL_FLOOR = 0.95


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(over):
    _, cfg, traffic, _, _ = harness.load_spec(CELL)
    cfg = {**cfg, **over}
    if over is FAULTS:
        cfg["limits"] = {**cfg["limits"], **FAULT_LIMITS}
    return cfg, traffic


@pytest.fixture(scope="module")
def built():
    """The clustered build at FAULTS: its answers at efSearch 64 and 16 and
    with the walk's products in TF32, its state, and the forward-only
    adjacency of the same rows."""
    torch.set_num_threads(1)
    cfg, traffic = config(FAULTS)
    keep = HNSWIndex.graph_max
    HNSWIndex.graph_max = 2000
    try:
        data, pool, system = harness.build(cfg, traffic, 21,
                                           torch.device("cpu"))
        pool = pool[:64]        # 3,072 queries judge every fault here
        answers = [system.search(b) for b in pool]
        fault = [system.fault_search(b) for b in pool]
        real = graph_ops.batched_scores
        graph_ops.batched_scores = lambda q, v, m, vn=None: real(
            to_tf32(q), to_tf32(v), m, vn)
        try:
            tf32 = [system.search(b) for b in pool]
        finally:
            graph_ops.batched_scores = real
        state = harness.free(system, torch.device("cpu"))
    finally:
        HNSWIndex.graph_max = keep
    xb = torch.cat([data.chunk(i) for i, _ in data.chunk_sizes()])
    real_fkeep = graph_ops.clustered_fkeep
    graph_ops.clustered_fkeep = lambda deg: deg
    try:
        forward = graph_ops.build_graph(
            xb, len(xb), 16, cfg["metric"], intermediate=128,
            exact_max=2000, refine_rounds=3).numpy()
    finally:
        graph_ops.clustered_fkeep = real_fkeep
    return dict(cfg=cfg, traffic=traffic, data=data, pool=pool,
                answers=answers, fault=fault, tf32=tf32, state=state,
                forward=forward)


def judge(b, answers, state=None):
    """(numbers with the reference's checks, failed answers)."""
    cfg, pool = b["cfg"], b["pool"]
    P, B = pool.shape[:2]
    numbers, failed, _, sol = harness.check_answers(
        cfg, b["traffic"], pool.reshape(P * B, -1), answers,
        [(0.0, 0.0, i) for i in range(P)],
        lambda q, wq, wl: ref.solve(cfg, b["data"], q,
                                    b["state"] if state is None else state,
                                    wq, wl), cfg["limits"])
    numbers.update({n: v for n, (v, _) in sol.checks.items()})
    return numbers, failed


def correct(cfg, numbers, failed) -> bool:
    return failed == 0 and all(numbers[n] <= cfg["limits"][n]
                               for n in numbers)


def test_the_clustered_build_is_correct(built):
    numbers, failed = judge(built, built["answers"])
    assert correct(built["cfg"], numbers, failed), numbers
    assert numbers["unreachable"] == 0.0
    assert built["state"]["graph"].shape == (20000, 16)


@pytest.mark.parametrize("how", ["label", "tf32", "twice", "ef16",
                                 "reverse"])
def test_a_fault_is_not_correct(built, how):
    answers = [a.copy() for a in built["answers"]]
    state = None
    if how == "label":       # one label moved to the next passage
        answers[3]["label"][5, 2] += 1
    elif how == "tf32":      # the walk's products in TF32
        answers = built["tf32"]
    elif how == "twice":     # a row returned at two ranks
        for field in ("label", "distance"):
            answers[7][field][9, 4] = answers[7][field][9, 3]
    elif how == "ef16":      # FAISS's default efSearch
        answers = built["fault"]
    else:                    # the prune that keeps every forward edge
        state = {"graph": built["forward"]}
    numbers, failed = judge(built, answers, state)
    assert not correct(built["cfg"], numbers, failed), numbers


def test_reference_is_numpy_brute_force():
    cfg, _ = config({"rows": 3000, "d": 16, "chunk_rows": 1024,
                     "centers": 64})
    data = harness.part("data", cfg["generator"]).Data(cfg, 5,
                                                       torch.device("cpu"))
    x = np.concatenate([data.chunk(i).numpy()
                        for i, _ in data.chunk_sizes()]).astype(np.float64)
    xq = data.queries(12)
    s = xq.astype(np.float64) @ x.T
    exact = np.argsort(-s, 1, kind="stable")[:, :cfg["k"]]
    adj = np.full((3000, 4), -1, np.int32)
    adj[:, 0] = (np.arange(3000) + 1) % 3000
    adj[:2000, 1] = 7                       # rows 2..2999 but 7 named once
    adj[5, 2] = 2999
    want_q = np.repeat(np.arange(12), 10)
    want_l = exact.reshape(-1).copy()
    want_l[:5] = np.argsort(s[0])[:5]       # query 0: half its top 10
    sol = ref.solve(cfg, data, xq, {"graph": adj}, want_q, want_l)
    np.testing.assert_allclose(sol.hi, -np.sort(-s, 1)[:, :cfg["k"]],
                               rtol=1e-12)
    assert np.isneginf(sol.lo).all()
    np.testing.assert_array_equal(sol.truth, exact)
    np.testing.assert_allclose(sol.want_score, s[want_q, want_l],
                               rtol=1e-12)
    assert sol.want_allowed.all()
    assert sol.detail["recall"] == pytest.approx((0.5 + 11) / 12)
    assert sol.checks["recall_miss"][0] == pytest.approx(0.5 / 12)
    assert sol.checks["unreachable"][0] == 0.0     # every row named once
    adj[:, 0] = 0
    adj[5, 2] = -1
    got = ref.solve(cfg, data, xq, {"graph": adj}, want_q, want_l)
    # named: 0 (column 0), 7; every other row unreachable
    assert got.checks["unreachable"][0] == pytest.approx(2998 / 3000)
    assert ref.solve(cfg, data, xq, {"graph": None}, want_q,
                     want_l).checks["unreachable"][0] == 1.0


def test_work_counts_by_hand():
    cfg = {"d": 16, "k": 2, "ef_search": 4, "graph_degree": 3}
    nbytes, ops = work.call_work(cfg, slice(5, 7))
    # 2 queries x 4 expansions x 3 candidates = 24 rows of 64 bytes, 8
    # adjacency rows of 12 bytes, 2 query rows, 2 x 2 results
    assert nbytes == 24 * 64 + 8 * 12 + 2 * 64 + 12 * 2 * 2 == 1808
    assert ops == {"tf32": 2 * 16 * 24}


def test_the_cell_runs_small_and_holds_its_recall():
    """IDMap,HNSW32 at 20,000 x 64 through one cell run: every distance
    exact within the limit, the recall at or above the floor."""
    res, lines = harness.run_cell(CELL, 3000000011, 0.3, False,
                                  device="cpu", overrides=SMALL)
    cmp = res["compared"]
    assert res["correct"] and res["failed"] == 0, cmp
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert res["metrics"]["recall_at_10"]["value"] >= RECALL_FLOOR
    assert cmp["dist_err"]["value"] <= cmp["dist_err"]["limit"]
    assert set(cmp) == {"dist_err", "rank_gap", "bad_answers",
                        "recall_miss", "unreachable"}
    assert lines[-1].startswith("compared unreachable")


def test_the_control_fails_dist_err():
    out = control.readings(CELL, 11, True, device="cpu", overrides={
        **SMALL, "rows": 6000, "d": 32})
    _, cfg, _, _, _ = harness.load_spec(CELL)
    lim = cfg["limits"]
    assert out["control"]["dist_err"] > lim["dist_err"], out
    assert out["program"]["bad_answers"] == 0
    assert out["program"]["dist_err"] <= lim["dist_err"]


def test_the_limit_readings_judge_the_fault_and_the_forward_rule(
        monkeypatch):
    """control_hnsw's readings on a clustered build at 6,000 x 32: the
    port within the limits, the TF32 control past dist_err, the efSearch
    16 fault judged with the reference's checks (recall_miss and
    unreachable there, no better than the port's), and the forward-only
    prune's graph leaving rows unnamed where the clustered rule leaves
    none; the rule is put back afterwards."""
    monkeypatch.setattr(HNSWIndex, "graph_max", 2000)
    over = {**SMALL, "rows": 6000, "d": 32, "factory": "IDMap,HNSW8,Flat",
            "graph_degree": 16}
    rule = graph_ops.clustered_fkeep
    got = {fwd: control_hnsw.readings(13, forward=fwd, device="cpu",
                                      overrides=over)
           for fwd in (False, True)}
    assert graph_ops.clustered_fkeep is rule
    out = got[False]
    assert out["program"]["over_limit"] == [], out
    assert out["program"]["failed"] == 0
    assert "dist_err" in out["control"]["over_limit"], out
    fault = out["fault_search"]
    assert {"recall_miss", "unreachable"} <= set(fault)
    assert fault["recall_miss"] >= out["program"]["recall_miss"]
    assert got[True]["program"]["unreachable"] > 0
    assert out["program"]["unreachable"] == 0


def test_a_port_without_device_ingest_is_refused(monkeypatch):
    """Before any corpus row is drawn, as on a port whose counters lack
    models.rows_device_adds."""
    import duckdb_faiss_ext_tpu_torch as dfx

    from benchmark.systems import hnsw as system

    real = dfx.faiss_stats
    monkeypatch.setattr(dfx, "faiss_stats", lambda **kw: {
        **real(**kw), "counters": {}})
    cfg, _ = config(SMALL)
    data = harness.part("data", cfg["generator"]).Data(cfg, 1,
                                                       torch.device("cpu"))
    monkeypatch.setattr(type(data), "chunk", lambda self, i: pytest.fail(
        "a row was drawn"))
    with pytest.raises(RuntimeError, match="no device-resident ingest"):
        system.System(cfg, data, torch.device("cpu"))


def test_the_configuration_is_complete():
    _, cfg, _, e2e, layer = harness.load_spec(CELL)
    from duckdb_faiss_ext_tpu_torch.metrics import resolve_metric

    index = HNSWIndex(cfg["d"], resolve_metric(cfg["metric"]), M=128)
    assert cfg["graph_degree"] == index._graph_degree()
    assert {m["name"] for m in e2e} == {"qps", "recall_at_10", "setup_s"}
    assert {m["name"] for m in layer} == {
        "device_idle_pct.graph", "roofline_pct.graph",
        "launches_per_call.graph", "idle_models_ms.graph",
        "call_p95_ms.graph", "torch_device_ms.graph", "idle_api_ms.graph"}
    assert set(cfg["limits"]) >= set(compare.NUMBERS) | {"recall_miss",
                                                          "unreachable"}
