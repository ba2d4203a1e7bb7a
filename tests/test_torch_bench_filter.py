"""The benchmark's filtered IVF family (``ivf_filter``: the upstream's own
``run_sel`` deployment, ``benchmark/configs/marco-ivf2048-hnsw128-flat.json``)
driven at a small size on the CPU: the system through the port's public
API, the plain reference against numpy, the work count by hand, and the
comparison turning ``correct`` false for each fault the cell can have (a
returned row that fails the filter, one probe short, k-means left at its
start, a row in its second list) and for the control (TF32 products)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import compare, control, harness
from benchmark.reference import ivf_filter as ref
from benchmark.work import ivf_filter as work

CELL = "marco-ivf2048-filter10-b48"
#: the configuration at a small size (its filter, metric and k kept)
TINY = {"rows": 6000, "d": 32, "nlist": 16, "nprobe": 4, "chunk_rows": 2048,
        "centers": 32, "train_rows": 4096, "factory": "IVF16_HNSW32,Flat"}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One torch thread, and a padded-layout budget that the small index
    passes, as the full one passes the card's, so that it is unpadded."""
    from duckdb_faiss_ext_tpu_torch.models.ivf import IVFIndex

    monkeypatch.setattr(IVFIndex, "LAYOUT_BUDGET_BYTES", 1 << 20)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(seed=5):
    _, cfg, _, _, _ = harness.load_spec(CELL)
    cfg = {**cfg, **TINY}
    return cfg, harness.part("data", cfg["generator"]).Data(
        cfg, seed, torch.device("cpu"))


def test_work_counts_by_hand():
    cfg = {"d": 16, "k": 2, "nlist": 4}
    detail = {"probes": np.array([[9, 9], [0, 1], [1, 3]]),
              "list_rows": np.array([5, 7, 0, 3]),
              "list_pass": np.array([1, 2, 0, 3])}
    nbytes, ops = work.call_work(cfg, slice(1, 3), detail)
    # lists 0, 1, 3 probed: 6 passing fp32 rows read once, 15 mask bits
    # (2 bytes), the 4 centroids, 2 queries, 2 x 2 results
    assert nbytes == 4 * 16 * (6 + 4 + 2) + 2 + 12 * 2 * 2 == 818
    assert ops == {"tf32": 2 * 16 * (2 * 4 + (1 + 2) + (2 + 3))}


def test_data_is_the_skewed_marco_mixture():
    (cfg, a), (_, b) = tiny(5), tiny(6)
    assert torch.equal(a.chunk(1), b.chunk(1))     # one corpus (corpus_seed)
    assert not np.array_equal(a.queries(8), b.queries(8))
    x = a.chunk(0)
    assert x.shape == (2048, 32)
    np.testing.assert_allclose(x.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    t = a.table()
    np.testing.assert_array_equal(t["sel"], t["i"] % 100)
    assert a.ids() is None
    assert ref.passing_rows(cfg, a).mean() == pytest.approx(0.1, abs=1e-3)


def test_reference_is_numpy_brute_force():
    cfg, data = tiny()
    x = np.concatenate([data.chunk(i).numpy()
                        for i, _ in data.chunk_sizes()]).astype(np.float64)
    rng = np.random.default_rng(0)
    cent = x[rng.choice(len(x), cfg["nlist"], replace=False)]
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    assign = (x @ cent.T).argmax(1)
    xq = data.queries(20)
    q = xq.astype(np.float64)
    probes = np.argsort(-(q @ cent.T), 1, kind="stable")[:, :cfg["nprobe"]]
    passing = np.arange(len(x)) % 100 < 10
    sol = ref.solve(cfg, data, xq, {"centroids": cent.astype(np.float32)},
                    np.array([0, 0, 0]), np.array([0, 5, 20]))
    s = q @ x.T
    for i in range(len(xq)):
        ok = np.isin(assign, probes[i]) & passing
        want = -np.sort(-s[i][ok])[:cfg["k"]]
        np.testing.assert_allclose(sol.hi[i], want, rtol=1e-9)
        np.testing.assert_allclose(sol.lo[i], want, rtol=1e-9)
    # rows 0 and 5 pass the filter (their sel below 10), row 20 does not
    reach0 = np.isin(assign[[0, 5, 20]], probes[0])
    assert sol.want_allowed.tolist() == [bool(reach0[0]), bool(reach0[1]),
                                         False]
    assert sol.truth is None
    np.testing.assert_array_equal(sol.detail["list_pass"], np.bincount(
        assign[passing], minlength=cfg["nlist"]))


def broken(monkeypatch, how: str):
    """Break the port's filter, probes, training or assignment
    underneath the cell."""
    from duckdb_faiss_ext_tpu_torch.models import ivf, ivf_layout

    from benchmark.systems import ivf_filter

    if how == "filter":      # the mask lets every row through
        monkeypatch.setattr(
            ivf_layout, "device_row_mask",
            lambda sel, row_pos, labels: torch.ones(
                row_pos.shape, dtype=torch.int8, device=row_pos.device))
    elif how == "probe":     # one probe short of the configuration's
        monkeypatch.setattr(ivf_filter.System, "search",
                            ivf_filter.System.fault_search)
    elif how == "train":     # k-means returns the table it started from
        real_fit = ivf.kmeans_fit
        monkeypatch.setattr(ivf, "kmeans_fit",
                            lambda x, k, **kw: real_fit(x, k, **{
                                **kw, "niter": 0}))
    elif how == "assign":    # every 8th row in its second nearest list
        real = ivf.IVFIndex._assign_candidates

        def assign(self, x):
            two = real(self, x, 2)
            return np.where(np.arange(len(two)) % 8 == 0, two[:, 1],
                            two[:, 0]).astype(np.int32)

        monkeypatch.setattr(ivf.IVFIndex, "_assign_lists", assign)


@pytest.mark.parametrize("how", [None, "filter", "probe", "train",
                                 "assign"])
def test_a_broken_filtered_path_is_not_correct(monkeypatch, how):
    from duckdb_faiss_ext_tpu_torch.utils.profiling import counters

    if how:
        broken(monkeypatch, how)
    before = counters()
    res, lines = harness.run_cell(CELL, 3000000011, 0.3, False,
                                  device="cpu", overrides=TINY)
    cmp = res["compared"]
    assert "kmeans_gain" in cmp and lines[-1].startswith("compared ")
    assert set(res["metrics"]) == {"qps", "setup_s"}
    if how is None:
        assert res["correct"] and res["failed"] == 0, cmp
        after = counters()
        assert after["api.selector_builds"] - \
            before.get("api.selector_builds", 0) == 1
        calls = res["attempted"] // 48 + 64      # the window's and set-up's
        assert after["models.unpadded_searches"] - \
            before.get("models.unpadded_searches", 0) == calls
    else:
        assert not res["correct"], cmp


def test_the_control_fails_a_limit():
    out = control.readings(CELL, 11, True, device="cpu", overrides=TINY)
    _, cfg, _, _, _ = harness.load_spec(CELL)
    lim = cfg["limits"]
    assert any(out["control"][n] > lim[n] for n in compare.NUMBERS), out
    assert out["program"]["bad_answers"] == 0
    assert out["fault_untrained_gain"] > lim["kmeans_gain"]
