"""The port's spans and cache-build counters on the CPU, and the benchmark's
reader of them (``benchmark/spans.py``):

* under a CPU ``torch.profiler``, one ``faiss_search`` on ``IDMap,Flat``
  and on ``IVF,Flat`` (the per-query scan and the pair tiles) yields one
  ``api.faiss_search`` root whose children carry the layers' names and
  nesting; a cold search shows its cache builds inside the dispatch;
* with no profiler recording, a span opens no profiler range;
* ``faiss_stats()["ops"]`` counts as before, and ``["counters"]`` counts
  cache builds: none on a repeated search, one layout after an add;
* the charge of idle time to spans, by hand on a Chrome-trace fixture, and
  the benchmark's existing readers unchanged by the spans' events;
* the reader on a real CPU slice, found through the harness's frame.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.models.ivf import IVFIndex
from duckdb_faiss_ext_tpu_torch.utils import profiling

from benchmark import harness, readers, spans, trace

D = 16


@pytest.fixture(autouse=True)
def cpu_device():
    """The CPU, on one torch thread: the test workers share the cores."""
    prev, threads = dt.config.device, torch.get_num_threads()
    dt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    dt.config.device = prev


def rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def catalog(factory: str) -> dt.Catalog:
    cat = dt.Catalog()
    dt.faiss_create("i", D, factory, catalog=cat)
    xb = rows(512)
    dt.faiss_add((np.arange(512) + 1000, xb) if "IDMap" in factory
                 else xb, "i", catalog=cat)
    return cat


def tree(path) -> list:
    """The port's spans of a Chrome trace as nested (name, children)."""
    ev = json.loads(path.read_text())["traceEvents"]
    sp = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e.get("cat") == "user_annotation"
                 and spans.layer_of(e["name"])),
                key=lambda t: (t[0], -t[1]))
    roots, stack = [], []
    for s, e, name in sp:
        while stack and not (s >= stack[-1][0] and e <= stack[-1][1]):
            stack.pop()
        node = (name, [])
        (stack[-1][2][1] if stack else roots).append(node)
        stack.append((s, e, node))
    return roots


def names(nodes) -> list:
    return [(n, names(c)) if c else n for n, c in nodes]


def search_tree(tmp_path, cat, nq, params=None, warm=True):
    q = rows(nq, seed=1)
    if warm:
        dt.faiss_search("i", 5, q, params, catalog=cat)
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        dt.faiss_search("i", 5, q, params, catalog=cat)
    return names(tree(path))


def root(dispatch: list) -> list:
    return [("api.faiss_search", [
        "api.args", ("models.dispatch", dispatch), "api.fetch",
        "models.labels", "api.format"])]


IVF_ROUTE = ["api.upload", "models.route", "models.coarse", "models.route"]


@pytest.mark.parametrize("case", ["flat", "flat-cold", "ivf", "ivf-cold",
                                  "ivf-pairs"])
def test_a_search_nests_its_spans_under_one_root(tmp_path, monkeypatch,
                                                 case):
    if case.startswith("flat"):
        got = search_tree(tmp_path, catalog("IDMap,Flat"), 3,
                          warm=case == "flat")
        build = ["models.rows_upload"] if case == "flat-cold" else []
        want = root(["api.upload"] + build + ["kernels.flat_topk"])
    elif case == "ivf-pairs":
        monkeypatch.setattr(IVFIndex, "PAIRS_MIN_WORK", 0)
        got = search_tree(tmp_path, catalog("IVF8,Flat"),
                          IVFIndex.PAIRS_MIN_BATCH, {"nprobe": "4"})
        want = root(IVF_ROUTE + [("kernels.ivf_pairs",
                                  ["kernels.ivf_pairs"])])
    else:
        got = search_tree(tmp_path, catalog("IVF8,Flat"), 3, {"nprobe": "4"},
                          warm=case == "ivf")
        build = ["models.layout_build"] if case == "ivf-cold" else []
        want = root(["api.upload"] + build + IVF_ROUTE[1:]
                    + ["kernels.ivf_list_scan"])
    assert got == want


def test_no_profiler_opens_no_range(monkeypatch, tmp_path):
    def refuse(name):
        raise AssertionError(f"a profiler range opened for {name}")

    monkeypatch.setattr(profiling, "_Range", refuse)
    for factory, params in (("IDMap,Flat", None), ("IVF8,Flat",
                                                   {"nprobe": "4"})):
        res = dt.faiss_search("i", 5, rows(3), params,
                              catalog=catalog(factory))
        assert res.shape == (3, 5)
    with profiling.span("api.x"):
        pass
    assert profiling.spanned("api.y")(lambda v: v + 1)(1) == 2
    # the same patch is what a recording profiler goes through
    cat = catalog("Flat")
    with pytest.raises(AssertionError, match="api.faiss_search"):
        with profiling.trace(str(tmp_path / "t.json")):
            dt.faiss_search("i", 5, rows(3), catalog=cat)


@pytest.mark.parametrize("traced", [False, True])
def test_ops_count_as_before(tmp_path, traced):
    cat = catalog("IDMap,Flat")
    before = dt.faiss_stats(catalog=cat)["ops"].get(
        "faiss_search", {"count": 0})["count"]
    if traced:
        with profiling.trace(str(tmp_path / "t.json")):
            for _ in range(3):
                dt.faiss_search("i", 5, rows(2), catalog=cat)
    else:
        for _ in range(3):
            dt.faiss_search("i", 5, rows(2), catalog=cat)
    ops = dt.faiss_stats(catalog=cat)["ops"]["faiss_search"]
    assert ops["count"] == before + 3
    assert ops["max_ms"] > 0 and ops["total_s"] > 0


def builds(name):
    return dt.faiss_stats()["counters"].get(name, 0)


@pytest.mark.parametrize("factory,counter", [
    ("IVF8,Flat", "models.layout_builds"),
    ("IDMap,Flat", "models.rows_uploads")])
def test_a_repeated_search_builds_nothing(factory, counter):
    cat = catalog(factory)
    q = rows(4, seed=2)
    first = builds(counter)
    dt.faiss_search("i", 5, q, {"nprobe": "4"}, catalog=cat)
    assert builds(counter) == first + 1
    snap = dt.faiss_stats()["counters"]
    dt.faiss_search("i", 5, q, {"nprobe": "4"}, catalog=cat)
    assert dt.faiss_stats()["counters"] == snap


def test_an_add_rebuilds_the_layout_once():
    cat = catalog("IVF8,Flat")
    q = rows(4, seed=3)
    dt.faiss_search("i", 5, q, {"nprobe": "4"}, catalog=cat)
    before = builds("models.layout_builds")
    dt.faiss_add(rows(64, seed=4), "i", catalog=cat)
    for _ in range(2):
        dt.faiss_search("i", 5, q, {"nprobe": "4"}, catalog=cat)
    assert builds("models.layout_builds") == before + 1


@pytest.mark.parametrize("factory,first_label", [("IDMap,Flat", 1000),
                                                 ("IVF8,Flat", 0)])
def test_a_repeated_filter_builds_its_mask_once(factory, first_label):
    cat = catalog(factory)
    mask = dt.create_mask([True] * 100,
                          np.arange(first_label, first_label + 100))
    before = builds("models.mask_builds")
    for _ in range(2):
        dt.faiss_search("i", 5, rows(2), {"nprobe": "4"}, catalog=cat,
                        selector=mask)
    assert builds("models.mask_builds") == before + 1


# --- the benchmark's reader, on a hand-built slice -------------------------

def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


#: two calls of 100 and 80 µs, three device operations, two host
#: operations
BASE = [event(trace.CALL, "user_annotation", 0, 100),
        event(trace.CALL, "user_annotation", 120, 80),
        event("flat_topk_partial", "kernel", 10, 20),
        event("Memcpy HtoD", "gpu_memcpy", 50, 10),
        event("flat_topk_merge", "kernel", 130, 20),
        event("aten::empty", "cpu_op", 5, 7),
        event("cudaLaunchKernel", "cuda_runtime", 70, 20)]
#: the port's spans: the first call nested three deep, then a fetch; the
#: second an upload
PORT = [event("api.faiss_search", "user_annotation", 2, 96),
        event("models.dispatch", "user_annotation", 4, 36),
        event("kernels.flat_topk", "user_annotation", 8, 27),
        event("api.fetch", "user_annotation", 45, 50),
        event("api.faiss_search", "user_annotation", 122, 76),
        event("api.upload", "user_annotation", 125, 35)]


def fixture(tmp_path, with_port: bool):
    path = tmp_path / ("with.json" if with_port else "without.json")
    path.write_text(json.dumps(
        {"traceEvents": BASE + (PORT if with_port else [])}))
    return path


def test_the_charge_by_hand(tmp_path):
    """Idle: [0, 10], [30, 50], [60, 130], [150, 200] µs (150 µs).  By the
    innermost span: caller 2 + 24 + 2, api.faiss_search 2 + 5 + 3 + 3 +
    38, models.dispatch 4 + 5, kernels.flat_topk 2 + 5, api.fetch 5 + 35,
    api.upload 5 + 10."""
    path = fixture(tmp_path, True)
    res = spans.from_trace(path, trace.parse(path, set()))
    by_hand = {"caller": 28, "api.faiss_search": 51, "models.dispatch": 9,
               "kernels.flat_topk": 7, "api.fetch": 40, "api.upload": 15}
    assert res["calls"] == 2
    assert res["by_span"] == pytest.approx(
        {n: v * 1e-3 / 2 for n, v in by_hand.items()}, rel=1e-9)
    assert res["by_layer"] == pytest.approx(
        {"api": 0.053, "models": 0.0045, "kernels": 0.0035,
         "caller": 0.014}, rel=1e-9)
    assert res["idle_ms"] == pytest.approx(0.075, rel=1e-9)
    assert sum(res["by_layer"].values()) == pytest.approx(res["idle_ms"],
                                                          rel=1e-12)
    assert res["root_self_share"] == pytest.approx(51 / 150, rel=1e-9)
    # a slice without the port's spans reads nothing
    bare = fixture(tmp_path, False)
    assert spans.from_trace(bare, trace.parse(bare, set())) is None


def fake_run(tr):
    return types.SimpleNamespace(
        seconds=1.0, setup_s=2.0, calls=[(0.0, 1e-3, 0), (1e-3, 3e-3, 1)],
        batch=48, recall=0.5, trace=tr, slice_bound_s=1e-4)


def test_the_existing_readers_do_not_see_the_spans(tmp_path):
    own = {"flat_topk_partial", "flat_topk_merge"}
    a = trace.parse(fixture(tmp_path, False), own)
    b = trace.parse(fixture(tmp_path, True), own)
    for f in ("window_s", "busy_s", "calls", "idle_by_host",
              "device_by_op"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("dev_start", "dev_end", "dev_own"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert trace.breakdown(a) == trace.breakdown(b)
    for fn in (readers.p95_ms, readers.device_idle_pct, readers.roofline_pct,
               readers.torch_device_ms, readers.launches_per_call):
        assert fn(fake_run(a)) == fn(fake_run(b)) is not None
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not m["name"].startswith("idle_"):
            read = harness.reader(m["name"])
            assert read(fake_run(a)) == read(fake_run(b)), m["name"]


def slice_of_searches(tmp_path, cat, calls: int):
    """The harness's traced slice over ``calls`` searches, stopped."""
    prof = trace.Slice(calls, tmp_path / "slice.json")
    while not prof.done:
        with torch.profiler.record_function(trace.CALL):
            dt.faiss_search("i", 5, rows(2), catalog=cat)
        prof.step()
    return prof


@pytest.mark.parametrize("recording", [True, False])
def test_the_reader_finds_the_slice_in_the_harness_frame(
        tmp_path, monkeypatch, capsys, recording):
    if not recording:   # a program without spans
        monkeypatch.setattr(profiling, "_recording", lambda: False)
    cat = catalog("IDMap,Flat")
    dt.faiss_search("i", 5, rows(2), catalog=cat)
    prof = slice_of_searches(tmp_path, cat, 4)
    run = fake_run(trace.parse(prof.path, set()))
    got = [harness.reader(f"idle_{la}_ms.latency")(run)
           for la in spans.LAYERS]
    err = capsys.readouterr().err
    if not recording:
        assert got == [None] * 3 and "no span" in err
        return
    res = spans.read(run)
    assert got == [res["by_layer"][la] for la in spans.LAYERS]
    assert all(v > 0 for v in got)
    assert sum(res["by_layer"].values()) == pytest.approx(res["idle_ms"],
                                                          rel=1e-9)
    assert err.count("spans: device idle ms a call over 4 calls") == 1
