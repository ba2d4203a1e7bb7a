"""The TREC accuracy-conformance flow on the port (tools/marco_mini.py's
generate → create_index → faiss_load → create_trec → score) against
tests/test_trec_flow.py's flow on the JAX package, over the same generated
files, on the CPU.

* ``Flat`` and ``IDMap,Flat`` (exact; IDMap's flow passes the row numbers
  to create_index as ``--ids``): the run files agree line by line in
  query id, doc id, rank and run name, their scores within 2e-6 (fp32
  scores written with six decimals), and both score 1.0.
* ``IVF16,Flat`` / ``IVF16,SQ8`` at nprobe 8: each metric within 0.02 of
  the JAX package's (the two packages' k-means differ by design).
"""

import filecmp
import os
import shutil
import sys

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.tools import marco_mini as tmini

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import marco_mini as jmini  # noqa: E402

N, D, NQ, K = 6000, 48, 32, 200


@pytest.fixture(autouse=True)
def cpu_and_cleanup():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev
    for name in ("build", "trec"):
        try:
            dfx.faiss_destroy(name)
        except Exception:
            pass


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """One generated corpus, queries and qrels (the JAX tool's generator,
    which both tools share through the harness's synthetic_dataset)."""
    work = tmp_path_factory.mktemp("gen")
    jmini.generate(str(work), N, D, NQ, seed=9)
    return work


def _id_flow(work, create_index, create_trec, factory, device):
    """marco_mini's flow with labels: create_index --ids (the row numbers,
    the qrels' doc ids) → create_trec → score."""
    ids = os.path.join(work, "ids.npy")
    np.save(ids, np.arange(N, dtype=np.int64))
    idx, run = os.path.join(work, "idx.dfx"), os.path.join(work, "run.trec")
    assert create_index.main(["--input", os.path.join(work, "corpus.npy"),
                              "--output", idx, "--factory", factory,
                              "--ids", ids] + device) == 0
    assert create_trec.main(["--index", idx, "--queries",
                             os.path.join(work, "queries.npy"), "--qids",
                             os.path.join(work, "qids.txt"), "--output", run,
                             "--k", str(K), "--run-name", "marco-mini"]
                            + device) == 0
    from duckdb_faiss_ext_tpu_torch.harness.trec import (read_qrels,
                                                         score_trec_run)

    return score_trec_run(run, read_qrels(os.path.join(work, "qrels.txt")),
                          recall_k=K)


def _flows(generated, tmp_path, factory, params):
    """Both flows over copies of the generated files: (JAX scores, port
    scores, JAX run path, port run path)."""
    dirs = []
    for side in ("jax", "torch"):
        d = tmp_path / side
        shutil.copytree(generated, d)
        dirs.append(str(d))
    if factory.startswith("IDMap"):
        import create_index
        import create_trec

        from duckdb_faiss_ext_tpu_torch.tools import create_index as tci
        from duckdb_faiss_ext_tpu_torch.tools import create_trec as tct

        want = _id_flow(dirs[0], create_index, create_trec, factory, [])
        got = _id_flow(dirs[1], tci, tct, factory, ["--cpu"])
    else:
        want = jmini.run_flow(dirs[0], factory, params, k=K,
                              train_fraction=0.5)
        for name in ("build", "trec"):
            dfx.faiss_destroy(name)
        got = tmini.run_flow(dirs[1], factory, params, k=K,
                             train_fraction=0.5, cpu=True)
    return (want, got, os.path.join(dirs[0], "run.trec"),
            os.path.join(dirs[1], "run.trec"))


def test_generate_matches_jax_tool(generated, tmp_path):
    tmini.generate(str(tmp_path), N, D, NQ, seed=9)
    for name in ("corpus.npy", "queries.npy", "qids.txt", "qrels.txt"):
        assert filecmp.cmp(generated / name, tmp_path / name, shallow=False)


@pytest.mark.parametrize("factory", ["Flat", "IDMap,Flat"])
def test_exact_flow_run_files_equal(generated, tmp_path, factory):
    want, got, want_run, got_run = _flows(generated, tmp_path, factory, None)
    assert got == want
    assert got["mrr@10"] == pytest.approx(1.0)
    assert got["ndcg@10"] == pytest.approx(1.0)
    assert got[f"recall@{K}"] == pytest.approx(1.0) and got["nq"] == NQ
    w = [ln.split() for ln in open(want_run).read().splitlines()]
    g = [ln.split() for ln in open(got_run).read().splitlines()]
    assert len(g) == len(w) == NQ * K
    assert [r[:4] + r[5:] for r in g] == [r[:4] + r[5:] for r in w]
    np.testing.assert_allclose([float(r[4]) for r in g],
                               [float(r[4]) for r in w], rtol=0, atol=2e-6)


@pytest.mark.parametrize("factory", ["IVF16,Flat", "IVF16,SQ8"])
def test_ivf_flow_scores_within_jax(generated, tmp_path, factory):
    want, got, _, _ = _flows(generated, tmp_path, factory, "nprobe=8")
    assert got["nq"] == want["nq"] == NQ
    for metric in ("mrr@10", "ndcg@10", f"recall@{K}"):
        assert abs(got[metric] - want[metric]) <= 0.02, (metric, got, want)
    assert got["mrr@10"] >= 0.9
