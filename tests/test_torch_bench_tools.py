"""The port's benchmark tools against the JAX package's on the CPU.

* ``tools/marco_filtered.py``: the port's ``run_sweep`` against the JAX
  tool's (``tools/marco_filtered.py`` loaded by path) on one IVF,SQ8 inner
  product index trained by the JAX package and carried into the port
  (``io/convert.py::from_reference``): the same pass rates and k' rows,
  and at each pass rate the bitmap and id-set strategies' labels equal to
  the JAX package's (labels equal, distances within 1e-5 of the largest),
  on the decode path and on the int8 path (the JAX package's interpreted
  Pallas kernels); each strategy's path is named.
* ``tools/marco_refine.py``: the port's rerank over an fp16 store on the
  candidates against the JAX tool's ``host_rerank`` (numpy over the same
  fp16 rows): labels equal where the distances are apart, distances within
  1e-6 relative, inner product and L2, with missing candidates.
* ``tools/batch_amortization.py``: the table's rows (each index at b1 /
  b48 / b256 / b1024 and 16 x b48) and the b1 result equal to row 0 of
  the b48 result.
* The ``--cpu`` command lines of the three tools run to their COMPLETE
  line; without ``--cpu`` on a machine with no card each raises.

Sizes: at most 20,000 rows, d at most 64, one torch thread.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.sql.engine import default_database
from duckdb_faiss_ext_tpu.utils.config import config as jax_config
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.models.refine import rerank
from duckdb_faiss_ext_tpu_torch.tools import (batch_amortization,
                                              marco_filtered, marco_refine,
                                              pairs_crossover)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the MS MARCO stand-in at a small size
MARCO_SMALL = ["--cpu", "--n", "6000", "--d", "32", "--chunk", "2048",
               "--clusters", "32", "--nlist", "16"]


def _jax_tool(name):
    """The JAX package's root tool ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def cpu_device():
    """The CPU, on one torch thread: the test workers share the cores."""
    prev, threads = dt.config.device, torch.get_num_threads()
    dt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    dt.config.device = prev
    dt.set_precision("parity")
    dt.set_sq_dot("auto")


def _unit_clustered(seed, n, d, ncl=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32)
    x = (centers[rng.integers(0, ncl, n)]
         + 0.4 * rng.standard_normal((n, d)).astype(np.float32))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _jax_int8(fn):
    dfx.set_sq_dot("int8")
    dfx.set_kernel_mode("pallas")
    jax_config.spill_impl = "pallas"
    try:
        return fn()
    finally:
        dfx.set_kernel_mode("auto")
        dfx.set_sq_dot("auto")
        jax_config.spill_impl = "auto"


def _assert_agree(got, want):
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    tol = 1e-5 * float(np.abs(wd[finite]).max())
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5, atol=tol)
    gap = np.abs(np.diff(np.where(finite, wd, np.inf), axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][sep], want["label"][sep])


# --- marco_filtered ---------------------------------------------------------

@pytest.mark.parametrize("sq_dot", ["decode", "int8"])
def test_marco_filtered_sweep_matches_jax_tool(sq_dot):
    n, d, nprobe, want = 8000, 32, 4, 10
    passrates = [0.01, 0.1, 0.5, 0.99]
    xb = _unit_clustered(1, n, d)
    xq = _unit_clustered(2, 6, d)
    name = f"bench_tools_filtered_{sq_dot}"
    jax_tool = _jax_tool("marco_filtered")
    dfx.faiss_create(name, d, "IVF16,SQ8", metric_type="INNER_PRODUCT")
    try:
        dfx.faiss_add(xb, name)
        pcat, pdb = dt.Catalog(), dt.Database()
        pcat.put(name, from_reference(dfx.GLOBAL_CATALOG.get(name)))
        jax_rows = jax_tool.run_sweep(name, xq, n, nprobe, passrates,
                                      want=want, iters=1)
        if sq_dot == "int8":
            dt.set_sq_dot("int8")
        rows = marco_filtered.run_sweep(name, xq, n, nprobe, passrates,
                                        want=want, iters=1, catalog=pcat,
                                        database=pdb, log=lambda m: None)
        assert [(r["result"].passrate, r["result"].required_k)
                for r in rows] \
            == [(r.passrate, r.required_k) for r in jax_rows]
        assert [r["result"].required_k for r in rows] == [1874, 183, 33, 11]
        jdb = default_database()
        params = {"nprobe": str(nprobe)}
        for r in rows:
            t = max(1, int(round(r["result"].passrate * 100)))
            filt = f"id%100<{t}"
            np.testing.assert_array_equal(r["sel"]["label"],
                                          r["set"]["label"])
            live = r["sel"]["label"] >= 0
            assert (r["sel"]["label"][live] % 100 < t).all()
            for key, fn in (("sel", dfx.faiss_search_filter),
                            ("set", dfx.faiss_search_filter_set)):
                def call(fn=fn):
                    return fn(name, want, xq, filt, "id", "ids", params,
                              database=jdb)
                want_res = _jax_int8(call) if sq_dot == "int8" else call()
                np.testing.assert_array_equal(r[key]["label"],
                                              want_res["label"])
                _assert_agree(r[key], want_res)
                assert r[f"{key}_path"].startswith(
                    "per-query (K2, k_scan 42: fused)" if sq_dot == "int8"
                    else "gather")
            if sq_dot == "decode":
                _assert_agree(r["post"], dfx.faiss_search(
                    name, r["result"].required_k, xq, params))
        if sq_dot == "int8":
            # k' = 1874 at 1%: k_scan 7496 capped at the probed rows
            assert "raw launch + top-k" in rows[0]["post_path"]
    finally:
        dfx.faiss_destroy(name)


def test_marco_filtered_cli(capsys):
    assert marco_filtered.main(MARCO_SMALL + ["--nq", "8", "--iters", "1",
                                              "--nprobe", "4"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"passrate\s+k_req\s+post_qps\s+sel_qps\s+set_qps\s+"
                     r"cpu_qps", out)
    for p, k in (("0.01", 1874), ("0.10", 183), ("0.50", 33), ("0.99", 11)):
        assert re.search(rf"^\s+{p}\s+{k}\s", out, re.M)
        assert re.search(rf"^  {p} \(id%100<\d+\): predicate over 6000 rows"
                         rf".*post k={k}: .*sel k=10: .*set k=10: ", out,
                         re.M)
    assert out.rstrip().endswith("MARCO-FILTERED COMPLETE")


def test_marco_filtered_config4_cli(capsys):
    assert marco_filtered.main(["--cpu", "--config4", "--n", "4000",
                                "--nlist", "16", "--nq", "8", "--nprobe",
                                "4", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "config4 build IVF16,Flat 4000x128" in out
    for label in ("post (k'=33)", "sel", "set"):
        assert re.search(rf"config4 id%2==0 {re.escape(label)}\s*: +[\d.]+ "
                         rf"ms \( *[\d.]+ qps\); per-query", out)
    assert out.rstrip().endswith("MARCO-FILTERED COMPLETE")


# --- marco_refine -----------------------------------------------------------

@pytest.mark.parametrize("metric", ["INNER_PRODUCT", "L2"])
def test_rerank_matches_jax_host_rerank(metric):
    rng = np.random.default_rng(3)
    n, d, nq, kb, k = 5000, 64, 12, 40, 10
    store = _unit_clustered(4, n, d).astype(np.float16)
    xq = _unit_clustered(5, nq, d)
    cand = rng.integers(0, n, (nq, kb)).astype(np.int64)
    cand[0, 5:] = -1                       # fewer candidates than k...
    cand[1, ::3] = -1                      # ...and holes
    want_d, want_l = _jax_tool("marco_refine").host_rerank(
        store, cand, xq, k, "IP" if metric == "INNER_PRODUCT" else "L2")
    got_d, got_l = (t.numpy() for t in rerank(
        torch.from_numpy(store), torch.from_numpy(cand), torch.from_numpy(xq),
        k, metric))
    finite = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), finite)
    np.testing.assert_array_equal(got_l[~finite], want_l[~finite])
    np.testing.assert_allclose(got_d[finite], want_d[finite], rtol=1e-6,
                               atol=1e-6)
    tol = 1e-6 * float(np.abs(want_d[finite]).max())
    gap = np.abs(np.diff(np.where(finite, want_d, np.inf), axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(got_l[sep], want_l[sep])
    assert (got_l[0, 5:] == -1).all()


def test_fp16_store_is_the_corpus():
    from duckdb_faiss_ext_tpu_torch.tools.marco_corpus import MarcoCorpus

    corpus = MarcoCorpus(5, device="cpu", d=16, centers=8, chunk_rows=1000)
    store = marco_refine.fp16_store(corpus, 2500)
    assert store.dtype == torch.float16 and store.shape == (2500, 16)
    rows = np.array([0, 999, 1000, 2499])
    np.testing.assert_array_equal(store[rows].numpy(),
                                  corpus.rows(rows, 2500).half().numpy())


def test_marco_refine_cli(capsys):
    assert marco_refine.main(MARCO_SMALL + ["--nq", "16", "--nprobes",
                                            "2,4", "--kfactors",
                                            "2,4"]) == 0
    out = capsys.readouterr().out
    assert "index IVF16,SQ6 IP" in out
    assert re.search(r"nprobe\s+k_factor\s+recall@10\s+base r@10\s+qps "
                     r"b1024", out)
    rows = re.findall(r"^\s+(\d+)\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+[\d.]+$",
                      out, re.M)
    assert [(int(a), int(b)) for a, b, *_ in rows] == [(2, 2), (2, 4),
                                                       (4, 2), (4, 4)]
    assert all(float(r) >= float(b) for *_, r, b in rows)
    assert out.rstrip().endswith("MARCO-REFINE COMPLETE")


# --- batch_amortization -----------------------------------------------------

def test_amortization_table_rows_and_b1_identity():
    n, d = 12000, 32
    rng = np.random.default_rng(6)
    xb = rng.standard_normal((n, d)).astype(np.float32)
    xq = rng.standard_normal((1024, d)).astype(np.float32)
    cat = dt.Catalog()
    dt.faiss_create("flat", d, "Flat", metric_type="L2", catalog=cat)
    dt.faiss_add(xb, "flat", catalog=cat)
    dt.faiss_create("ivf", d, "IVF32,Flat", metric_type="L2", catalog=cat)
    dt.faiss_manual_train(xb[:4000], "ivf", catalog=cat)
    dt.faiss_add(xb, "ivf", catalog=cat)
    rows = batch_amortization.amortization_table(
        cat, ("flat", "ivf"), xq, (None, {"nprobe": "8"}), iters=1,
        log=lambda m: None)
    assert [(r["index"], r["batch"]) for r in rows] == [
        (name, b) for name in ("flat", "ivf")
        for b in (1, 48, 256, 1024, "16xb48")]
    for name in ("flat", "ivf"):
        by = {r["batch"]: r for r in rows if r["index"] == name}
        assert by[1]["ratio"] == 1.0 and by["16xb48"]["ratio"] is None
        for b in (1, 48, 256, 1024):
            assert by[b]["result"].shape == (b, 10)
            assert by[b]["qps"] == pytest.approx(b / by[b]["ms"] * 1e3)
        for key in ("label", "distance"):
            np.testing.assert_array_equal(by[1]["result"][key][0],
                                          by[48]["result"][key][0])
        np.testing.assert_array_equal(by["16xb48"]["result"]["label"][:48],
                                      by[48]["result"]["label"])


def test_batch_amortization_cli(capsys):
    assert batch_amortization.main(["--cpu", "--n", "8000", "--d", "16",
                                    "--nlist", "16", "--train", "2000",
                                    "--nprobe", "4"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"index\s+batch\s+ms/batch\s+qps\s+vs b1 latency", out)
    for name in ("flat", "ivf"):
        for b in (1, 48, 256, 1024):
            assert re.search(rf"^\s+{name}\s+{b}\s+[\d.]+\s+[\d.]+\s+"
                             rf"[\d.]+x$", out, re.M)
        assert re.search(rf"^\s+{name}\s+16xb48\s.*\(pipelined\)$", out,
                         re.M)
    assert out.rstrip().endswith("BATCH-AMORTIZATION COMPLETE")


# --- no card, no fallback ---------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (marco_filtered, ["--n", "6000", "--d", "32"]),
    (marco_filtered, ["--config4", "--n", "4000"]),
    (marco_refine, ["--n", "6000", "--d", "32"]),
    (batch_amortization, ["--n", "8000", "--d", "16"]),
    (pairs_crossover, ["--grid", "32:16"])])
def test_tools_need_a_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(Exception, match="(?i)cuda"):
        tool.main(argv)
