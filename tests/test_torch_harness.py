"""The port's harness (``duckdb_faiss_ext_tpu_torch.harness``) against the
JAX package's.

* ``synthetic_dataset`` returns arrays byte-equal to the JAX package's for
  the same arguments and seed;
* ``required_k``, ``prob_at_least`` and ``recall_at_k`` equal the JAX
  package's;
* the fvecs / ivecs / bvecs loaders read files written to ``tmp_path``
  as the JAX package's do;
* TREC: a Flat run file (inner product) is identical to the JAX
  package's, byte for byte; under L2 (expansion-form fp32 sums in another
  order) the (query, doc, rank) columns agree wherever the distances are
  apart and the scores within 1e-5 of the largest ‖q‖²; the qrels and the
  scorer equal the JAX package's; the create → save → load → run → score
  flow of tests/test_trec_flow.py is perfect on Flat and meets its floor
  on IVF16 (a JAX-trained index carried by ``from_reference``);
* ``autotune_index``: recall at every nprobe equal to the JAX package's on
  a JAX-trained IVF carried by ``from_reference`` (the port's own k-means
  differs on purpose); one exhaustive point for the knobless families;
* ``run_filtered_bench`` runs its three strategies, and its CPU baseline
  scales with the corpus rows (the JAX package scales it by the query
  count, harness/filtered.py:166).

No timing ratio is asserted (the intermittent failure of
tests/test_harness.py::test_cpu_filtered_baseline_column).
"""

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu.harness as jh
import duckdb_faiss_ext_tpu_torch as dt
import duckdb_faiss_ext_tpu_torch.harness as ph
from duckdb_faiss_ext_tpu.harness import datasets as jds
from duckdb_faiss_ext_tpu.harness import filtered as jfilt
from duckdb_faiss_ext_tpu.harness import trec as jtrec
from duckdb_faiss_ext_tpu_torch.harness import datasets as pds
from duckdb_faiss_ext_tpu_torch.harness import filtered as pfilt
from duckdb_faiss_ext_tpu_torch.harness import trec as ptrec
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


@pytest.mark.parametrize("args", [
    dict(n=1000, d=16, nq=10, ncl=8, seed=1),
    dict(n=4096, d=128, nq=48, ncl=1024, seed=42),
    dict(n=777, d=7, nq=3, ncl=5, seed=9),
])
def test_synthetic_dataset_byte_equal(args):
    for got, want in zip(ph.synthetic_dataset(**args),
                         jh.synthetic_dataset(**args)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("want,p", [(10, 0.5), (10, 1.0), (10, 0.01),
                                    (5, 0.1), (100, 0.9), (1, 0.99)])
def test_required_k_matches_jax(want, p):
    k = ph.required_k(want, p)
    assert k == jh.required_k(want, p)
    assert pfilt.prob_at_least(want, k, p) >= 0.99
    if k > want:
        assert pfilt.prob_at_least(want, k - 1, p) < 0.99
    assert pfilt.prob_at_least(want, k, p) == jfilt.prob_at_least(want, k,
                                                                  p)


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(3)
    got = rng.integers(0, 50, (40, 10))
    gt = rng.integers(0, 50, (40, 12))
    for k in (None, 5, 10):
        assert ph.recall_at_k(got, gt, k) == jh.recall_at_k(got, gt, k)
    assert ph.recall_at_k(np.array([[1, 2, 3], [4, 5, 6]]),
                          np.array([[1, 2, 9], [9, 9, 9]])) == 2 / 6


def test_vecs_loaders_read_local_files(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 6)).astype(np.float32)
    ids = rng.integers(0, 1000, (9, 4)).astype(np.int32)
    b = rng.integers(0, 256, (9, 5)).astype(np.uint8)
    f, i, bv = (str(tmp_path / n) for n in ("a.fvecs", "a.ivecs", "a.bvecs"))
    np.hstack([np.full((9, 1), 6, np.int32), x.view(np.int32)]).tofile(f)
    np.hstack([np.full((9, 1), 4, np.int32), ids]).tofile(i)
    np.hstack([np.tile(np.frombuffer(np.int32(5).tobytes(), np.uint8),
                       (9, 1)), b]).tofile(bv)
    for mod in (pds, jds):
        np.testing.assert_array_equal(mod.load_fvecs(f), x)
        np.testing.assert_array_equal(mod.load_fvecs(f, max_rows=4), x[:4])
        np.testing.assert_array_equal(mod.load_ivecs(i), ids)
        np.testing.assert_array_equal(mod.load_bvecs(bv, max_rows=3),
                                      b[:3].astype(np.float32))
    empty = str(tmp_path / "e.fvecs")
    open(empty, "wb").close()
    assert pds.load_fvecs(empty).shape == jds.load_fvecs(empty).shape


def _flat_pair(catalog, pcat, metric, xb):
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("t", xb.shape[1], "Flat", metric_type=metric,
                         catalog=cat)
        mod.faiss_add(xb, "t", catalog=cat)


@pytest.mark.parametrize("metric", ["INNER_PRODUCT", "L2"])
def test_trec_run_file_matches_jax(catalog, pcat, tmp_path, metric):
    xb, xq = ph.synthetic_dataset(n=3000, d=16, nq=12, ncl=8, seed=2)
    _flat_pair(catalog, pcat, metric, xb)
    qids = [f"q{i}" for i in range(12)]
    jpath, ppath = str(tmp_path / "j.run"), str(tmp_path / "p.run")
    jtrec.write_trec_run(jpath, "t", qids, xq, k=100, catalog=catalog,
                         batch=5)
    ptrec.write_trec_run(ppath, "t", qids, xq, k=100, catalog=pcat, batch=5)
    jlines, plines = (open(p).read().splitlines() for p in (jpath, ppath))
    if metric == "INNER_PRODUCT":
        assert plines == jlines
        return
    assert len(plines) == len(jlines) == 1200
    js, ps = ([ln.split() for ln in lines] for lines in (jlines, plines))
    jd = np.array([float(r[4]) for r in js]).reshape(12, 100)
    pd_ = np.array([float(r[4]) for r in ps]).reshape(12, 100)
    tol = 1e-5 * float((xq * xq).sum(1).max())
    np.testing.assert_allclose(pd_, jd, rtol=0, atol=tol + 1e-6)
    gap = np.abs(np.diff(jd, axis=1)) > 2 * tol + 2e-6
    sep = np.ones_like(jd, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    cols = [(r[0], r[2], r[3]) for r in js]
    pcols = [(r[0], r[2], r[3]) for r in ps]
    for i in np.flatnonzero(sep.reshape(-1)):
        assert pcols[i] == cols[i]


def test_qrels_and_scorer_match_jax(tmp_path):
    xb, xq = ph.synthetic_dataset(n=2000, d=12, nq=6, ncl=8, seed=5)
    qids = list(range(6))
    for metric in ("L2", "INNER_PRODUCT"):
        q = ptrec.make_synthetic_qrels(xb, xq, qids, metric=metric)
        assert q == jtrec.make_synthetic_qrels(xb, xq, qids, metric=metric)
    path = str(tmp_path / "q.qrels")
    ptrec.write_qrels(path, q)
    assert ptrec.read_qrels(path) == jtrec.read_qrels(path)
    run = tmp_path / "run.trec"
    run.write_text("1 Q0 5 1 9.0 t\n1 Q0 7 2 8.0 t\n1 Q0 6 3 7.0 t\n"
                   "2 Q0 9 1 5.0 t\n")
    qrels = {"1": {"5": 2, "6": 1}, "2": {"8": 1}}
    got = ptrec.score_trec_run(str(run), qrels, mrr_k=10, ndcg_k=10,
                               recall_k=10)
    assert got == jtrec.score_trec_run(str(run), qrels, mrr_k=10, ndcg_k=10,
                                       recall_k=10)
    assert got["mrr@10"] == pytest.approx(0.5)


def _trec_flow(pcat, tmp_path, name, k=200, params=None):
    """create (train + add) → save → load → run file → score against
    exact-search qrels, on the port; returns the scores."""
    xb, xq = ph.synthetic_dataset(n=6000, d=48, nq=32, ncl=64, seed=9)
    qids = list(range(32))
    qrels = ptrec.make_synthetic_qrels(xb, xq, qids, metric="L2")
    path = str(tmp_path / f"{name}.dfx")
    dt.faiss_save(name, path, catalog=pcat)
    dt.faiss_load("trec", path, catalog=pcat)
    run = str(tmp_path / f"{name}.run")
    ptrec.write_trec_run(run, "trec", qids, xq, k=k, params=params,
                         catalog=pcat)
    return ptrec.score_trec_run(run, qrels, recall_k=k)


def test_trec_flow_exact_flat_is_perfect(pcat, tmp_path):
    xb, _ = ph.synthetic_dataset(n=6000, d=48, nq=32, ncl=64, seed=9)
    dt.faiss_create("build", 48, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "build", catalog=pcat)
    scores = _trec_flow(pcat, tmp_path, "build")
    assert scores["mrr@10"] == pytest.approx(1.0)
    assert scores["ndcg@10"] == pytest.approx(1.0)
    assert scores["recall@200"] == pytest.approx(1.0)
    assert scores["nq"] == 32


def test_trec_flow_ivf_meets_floor(catalog, pcat, tmp_path):
    xb, _ = ph.synthetic_dataset(n=6000, d=48, nq=32, ncl=64, seed=9)
    dfx.faiss_create("build", 48, "IVF16,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_manual_train(xb[:3000], "build", catalog=catalog)
    dfx.faiss_add(xb, "build", catalog=catalog)
    pcat.put("build", from_reference(catalog.get("build")))
    scores = _trec_flow(pcat, tmp_path, "build", params={"nprobe": "8"})
    assert scores["mrr@10"] >= 0.9
    assert scores["ndcg@10"] >= 0.85
    assert scores["recall@200"] >= 0.9


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_autotune_recall_matches_jax(catalog, pcat, metric):
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((32, 16)).astype(np.float32) * 5
    xb = (centers[rng.integers(0, 32, 6000)]
          + rng.standard_normal((6000, 16)).astype(np.float32) * 0.2)
    dfx.faiss_create("tune", 16, "IVF32,Flat", metric_type=metric,
                     catalog=catalog)
    dfx.faiss_add(xb, "tune", catalog=catalog)
    pcat.put("tune", from_reference(catalog.get("tune")))
    want = jh.autotune_index("tune", xb[:64], k=10, target_recall=0.95,
                             catalog=catalog, repeat=1)
    got = ph.autotune_index("tune", xb[:64], k=10, target_recall=0.95,
                            catalog=pcat, repeat=1)
    assert [p.params for p in got.points] == [p.params for p in want.points]
    assert [p.recall for p in got.points] == [p.recall for p in want.points]
    assert len(got.points) == 6 and got.points[-1].recall == 1.0
    assert got.points[-1].pareto
    assert got.best is not None and got.best.recall >= 0.95
    assert all(p.qps > 0 for p in got.points)
    assert "nprobe" in str(got)


def test_autotune_graph_sweep_matches_jax(catalog, pcat):
    """The efSearch sweep of an HNSW index in its graph regime (the JAX
    package's adjacency carried across, its walk unpacked) against the
    exact scan: the same settings and the same recall at each."""
    rng = np.random.default_rng(5)
    # 20,000 rows: past 8,192 graph rows the walk's seeds are a strided
    # sample, not the whole corpus.
    xb = rng.standard_normal((20_000, 16)).astype(np.float32)
    dfx.faiss_create("g", 16, "HNSW16", metric_type="L2", catalog=catalog)
    index = catalog.get("g").index
    index.ann_threshold = 1000
    index._graph_pack = lambda *a: None
    dfx.faiss_add(xb, "g", catalog=catalog)
    dfx.faiss_search("g", 1, xb[:1], catalog=catalog)      # builds the graph
    pcat.put("g", from_reference(catalog.get("g")))
    xq = xb[:64] + rng.standard_normal((64, 16)).astype(np.float32)
    want = jh.autotune_index("g", xq, k=10, target_recall=0.99,
                             catalog=catalog, repeat=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # many small ops: see tests/test_torch_hnsw.py
    try:
        got = ph.autotune_index("g", xq, k=10, target_recall=0.99,
                                catalog=pcat, repeat=1)
    finally:
        torch.set_num_threads(threads)
    assert [p.params for p in got.points] == [p.params for p in want.points]
    assert [p.params["efSearch"] for p in got.points] == [
        "16", "32", "64", "128", "256", "512", "1024"]
    assert [p.recall for p in got.points] == [p.recall for p in want.points]
    assert got.points[0].recall < got.points[-1].recall
    assert pcat.get("g").index._graph is not None


@pytest.mark.parametrize("factory", ["Flat", "SQ8", "IDMap,SQfp16"])
def test_autotune_knobless(pcat, factory):
    xb = np.random.default_rng(4).standard_normal((2000, 8)).astype(
        np.float32)
    dt.faiss_create("t", 8, factory, catalog=pcat)
    dt.faiss_add((np.arange(2000), xb) if factory.startswith("IDMap")
                 else xb, "t", catalog=pcat)
    res = ph.autotune_index("t", xb[:16], k=5, catalog=pcat, repeat=1)
    assert len(res.points) == 1 and res.points[0].recall == 1.0
    assert res.best is res.points[0]


def test_filtered_bench_runs_and_scales_cpu_by_corpus_rows(pcat,
                                                           monkeypatch):
    xb, xq = ph.synthetic_dataset(n=2000, d=16, nq=8, ncl=8, seed=1)
    ids = np.arange(2000)
    dt.faiss_create("b", 16, "IDMap,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add((ids, xb), "b", catalog=pcat)
    db = dt.Database()
    db.register("t", {"id": ids})
    seen = []

    def baseline(d, n_total, queries, want, passrate, metric, iters):
        seen.append((n_total, metric))
        return 1.0

    monkeypatch.setattr(pfilt, "cpu_filtered_baseline", baseline)
    results = ph.run_filtered_bench("b", xq, "t", "id",
                                    passrates=(0.5, 0.1), want=5,
                                    catalog=pcat, database=db, iters=1,
                                    cpu_baseline=True)
    assert [r.passrate for r in results] == [0.5, 0.1]
    for r in results:
        assert r.qps_post > 0 and r.qps_sel > 0 and r.qps_set > 0
        assert r.required_k >= 5 and r.qps_cpu == 1.0
    assert seen == [(2000, "L2"), (2000, "L2")]
    dt.faiss_create("c", 16, "Flat", metric_type="INNER_PRODUCT",
                    catalog=pcat)
    dt.faiss_add(xb[:1500], "c", catalog=pcat)
    ph.run_filtered_bench("c", xq, "t", "id", passrates=(0.5,), want=5,
                          catalog=pcat, database=db, iters=1,
                          cpu_baseline=True)
    assert seen[-1] == (1500, "INNER_PRODUCT")


def test_cpu_filtered_baseline_matches_jax_selection():
    """The CPU column's scan is the JAX package's: a positive rate for
    both metrics (no timing ratio asserted)."""
    xq = np.random.default_rng(0).standard_normal((8, 32)).astype(
        np.float32)
    for metric in ("L2", "INNER_PRODUCT"):
        assert pfilt.cpu_filtered_baseline(32, 100_000, xq, want=5,
                                           passrate=0.5, metric=metric,
                                           sample=4096, iters=1) > 0
