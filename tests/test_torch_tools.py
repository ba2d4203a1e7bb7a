"""The port's command-line tools (duckdb_faiss_ext_tpu_torch/tools/), each
run with ``--cpu`` at a small size through its ``main(argv)``: exit 0 and
the output lines of the JAX package's tool of the same name.  Two of them
also run as ``python -m duckdb_faiss_ext_tpu_torch.tools.<name>`` in a
subprocess, and one without ``--cpu`` on a machine without a card, where
it must fail instead of running on the CPU.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.tools import (autotune, benchmark_filtered,
                                              conformance, create_index,
                                              create_trec, marco_device,
                                              marco_graph, marco_mini,
                                              marco_trec, run_reference_tests)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

#: a small MS MARCO stand-in for the marco tools
MARCO_SMALL = ["--cpu", "--n", "6000", "--d", "32", "--chunk", "2048",
               "--clusters", "32"]


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


def _embeddings(tmp_path, n=3000, d=16, seed=0):
    xb = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    path = tmp_path / "emb.npy"
    np.save(path, xb)
    return xb, str(path)


def test_create_index_and_create_trec(tmp_path, capsys):
    xb, emb = _embeddings(tmp_path)
    out = str(tmp_path / "idx.dfx")
    assert create_index.main(["--input", emb, "--output", out, "--factory",
                              "IVF16,Flat", "--metric", "L2",
                              "--train-fraction", "0.5", "--cpu"]) == 0
    text = capsys.readouterr().out
    assert "loaded 3000 × 16 vectors" in text
    assert re.search(r"trained on 1500 rows in", text)
    assert "added 3000/3000" in text and f"saved to {out}" in text
    assert os.path.getsize(out) > 0
    q = tmp_path / "q.npy"
    np.save(q, xb[:5])
    run = str(tmp_path / "run.trec")
    assert create_trec.main(["--index", out, "--queries", str(q), "--output",
                             run, "--k", "20", "--params", "nprobe=16",
                             "--cpu"]) == 0
    assert f"wrote {run}" in capsys.readouterr().out
    lines = open(run).read().splitlines()
    assert len(lines) == 5 * 20
    first = lines[0].split()
    assert first[:4] == ["0", "Q0", "0", "1"] and first[5] == "dfx-tpu"


def test_create_index_csv_with_ids(tmp_path, capsys):
    rows = np.loadtxt(os.path.join(DATA, "training.csv"), delimiter=",")
    out = str(tmp_path / "idx.dfx")
    assert create_index.main(["--input", os.path.join(DATA, "training.csv"),
                              "--output", out, "--factory", "IDMap,Flat",
                              "--metric", "L2", "--cpu"]) == 0
    assert f"loaded {rows.shape[0]} × 8 vectors" in capsys.readouterr().out
    cat = dt.Catalog()
    dt.faiss_load("l", out, catalog=cat)
    res = dt.faiss_search("l", 1, rows[:3, 1:].astype(np.float32),
                          catalog=cat)
    np.testing.assert_array_equal(res["label"][:, 0], rows[:3, 0])


def test_marco_mini_flow(tmp_path, capsys):
    assert marco_mini.main(["--n", "3000", "--d", "24", "--nq", "16",
                            "--factory", "Flat", "--params", "",
                            "--workdir", str(tmp_path), "--cpu"]) == 0
    text = capsys.readouterr().out
    scores = json.loads(text.strip().splitlines()[-1])
    assert scores["factory"] == "Flat" and scores["nq"] == 16
    assert scores["mrr@10"] == 1.0 and scores["ndcg@10"] == 1.0
    assert f"workdir {tmp_path}" in text
    assert re.search(r"generated 3000x24 \+ qrels in", text)


def test_conformance(tmp_path, capsys):
    trec = str(tmp_path / "c.trec")
    assert conformance.main(["--factory", "IVF32,Flat", "--n", "4000",
                             "--d", "16", "--nq", "32", "--nprobe", "32",
                             "--trec", trec, "--cpu"]) == 0
    out = capsys.readouterr()
    m = re.search(r"recall@10: ([0-9.]+)\s+qps: [0-9.]+", out.out)
    assert m and float(m.group(1)) == 1.0       # every list probed
    assert "corpus 4000×16, 32 queries, index IVF32,Flat" in out.err
    assert f"wrote {trec}" in out.err
    assert len(open(trec).read().splitlines()) == 32 * 10


def test_benchmark_filtered(capsys):
    assert benchmark_filtered.main(["--n", "4000", "--d", "16", "--nq", "8",
                                    "--passrates", "10,50", "--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["passrate", "k_req", "post_qps", "sel_qps",
                                "set_qps"]
    assert [ln.split()[0] for ln in lines[1:]] == ["0.10", "0.50"]
    assert all(float(v) > 0 for ln in lines[1:] for v in ln.split()[2:])


def test_autotune(capsys):
    assert autotune.main(["--n", "4000", "--d", "16", "--nq", "32",
                          "--factory", "IVF16,Flat", "--ncl", "64",
                          "--cpu"]) == 0
    text = capsys.readouterr().out
    assert "operating points (k=10, target recall 0.90):" in text
    assert "<- best" in text


def test_run_reference_tests(tmp_path, capsys):
    for name in ("training.csv", "queries.csv"):
        shutil.copy(os.path.join(DATA, name), tmp_path / name)
    (tmp_path / "a.test").write_text(
        "require faiss\n\nstatement ok\n"
        "CALL faiss_create('f8', 8, 'IDMap,Flat');\n\n"
        "statement error\nCALL faiss_create('f8', 8, 'Flat');\n----\n"
        "Invalid Input Error: Index f8 already exists.\n\n"
        "statement ok\nCALL faiss_destroy('f8');\n")
    assert run_reference_tests.main([str(tmp_path), "--cpu"]) == 0
    text = capsys.readouterr().out
    assert "PASS a.test: 3/3" in text and "TOTAL 3/3" in text
    (tmp_path / "b.test").write_text(
        "statement ok\nCALL faiss_destroy('never_made');\n")
    assert run_reference_tests.main([str(tmp_path), "--cpu"]) == 1
    text = capsys.readouterr().out
    assert "FAIL b.test: 0/1" in text and "TOTAL 3/4" in text
    assert run_reference_tests.main([str(tmp_path / "none"), "--cpu"]) == 2


def test_marco_device(capsys):
    assert marco_device.main(MARCO_SMALL + ["--nlist", "16", "--nprobes",
                                            "16", "--batches", "48",
                                            "--nq", "16"]) == 0
    text = capsys.readouterr().out
    assert "index IVF16,SQ8 IP, built on the cpu" in text
    assert re.search(r"device ingest: .* spill \d+ rows", text)
    rec = [float(v) for v in re.findall(r"recall@10 ([0-9.]+)", text)]
    assert len(rec) == 1 and rec[0] > 0.9        # every list probed
    assert text.count("pipelined 8xb256 nprobe=16") == 1
    assert text.strip().endswith("MARCO-DEVICE RUN COMPLETE")


def test_marco_trec(tmp_path, capsys):
    run = str(tmp_path / "m.run")
    assert marco_trec.main(MARCO_SMALL + ["--nlist", "16", "--nprobe", "16",
                                          "--k", "100", "--nq", "16",
                                          "--out", run]) == 0
    text = capsys.readouterr().out
    m = re.search(r"TREC scores: mrr@10=([0-9.]+)\s+ndcg@10=([0-9.]+)\s+"
                  r"recall@100=([0-9.]+)\s+nq=16", text)
    assert m and float(m.group(1)) > 0.9 and float(m.group(3)) > 0.9
    assert len(open(run).read().splitlines()) == 16 * 100
    assert "MARCO-TREC COMPLETE" in text


def test_marco_graph(capsys):
    assert marco_graph.main(MARCO_SMALL + [
        "--half-k", "6", "--train-rows", "2048", "--inter", "16", "--deg",
        "16", "--pools", "16,64", "--batches", "48", "--edge-sample", "64",
        "--refine-rounds", "1", "--serve-codec", "sq8"]) == 0
    text = capsys.readouterr().out
    for line in ("phase1 product-cell k-means", "phase2 sq4 encode",
                 "phase3 coded clustered scan", "phase3 descent round 1",
                 "phase3 augment_graph to degree 16", "phase4 sq8 encode"):
        assert line in text
    assert re.search(r"membership coverage 1\.0000", text)
    edge = float(re.search(r"edge recall of the k-NN graph after 1 descent "
                           r"rounds: ([0-9.]+)", text).group(1))
    assert edge > 0.5
    rec = [float(v) for v in re.findall(r"walk b48 ef=\d+: .* recall@10 "
                                        r"([0-9.]+)", text)]
    assert len(rec) == 2 and rec[1] > 0.8
    assert text.strip().endswith("MARCO-GRAPH COMPLETE")


@pytest.mark.parametrize("module,args,expect", [
    ("autotune", ["--n", "2000", "--d", "8", "--nq", "16", "--factory",
                  "IVF8,Flat", "--ncl", "16"], "operating points"),
    ("create_trec", ["--help"], "--queries"),
])
def test_runs_as_module(module, args, expect):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", f"duckdb_faiss_ext_tpu_torch.tools.{module}"]
        + args + (["--cpu"] if args != ["--help"] else []),
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout


def test_tool_without_a_card_fails():
    """The card is the default: without one, a tool raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        autotune.main(["--n", "100", "--d", "4"])
