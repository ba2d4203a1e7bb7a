"""CPU tests of the benchmark harness (run with ``pytest benchmark/``).

They check that nothing here loads JAX or the JAX package (and that the
reference loads nothing of the port), that every name in BENCHMARK.json
resolves to its files, the work counts, the references against brute
force in numpy, that the command refuses to run without a card, and that
the comparison turns ``correct`` false for the faults a cell can have and
for the control (TF32 products, emulated exactly on the CPU).
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import common, flat as ref_flat, ivf_flat as ref_ivf
from benchmark.work import bound_s, flat as work_flat, ivf_flat as work_ivf

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

#: small shapes of the two configurations (widths of the flat one kept)
TINY_FLAT = {"rows": 4096, "chunk_rows": 1024, "centers": 32}
#: 4 clusters over 16 lists, so that a query's neighbours spread over the
#: lists it probes
TINY_IVF = {"rows": 4096, "chunk_rows": 1024, "centers": 4, "nlist": 16,
            "nprobe": 4, "factory": "IVF16,Flat"}


def top_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


def test_no_jax_and_no_port_in_the_reference():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        mods = top_modules(f)
        assert not mods & {"jax", "jaxlib", "flax", "duckdb_faiss_ext_tpu"}, f
        if "reference" in f.relative_to(BENCH).parts:
            assert "duckdb_faiss_ext_tpu_torch" not in mods, f


def test_every_name_resolves_to_its_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for kind in ("systems", "work", "reference"):
            assert (BENCH / kind / f"{cfg['family']}.py").is_file()
        assert (BENCH / "data" / f"{cfg['generator']}.py").is_file()
        assert set(compare.NUMBERS) <= set(cfg["limits"])
        assert int(cfg["host_threads"]) >= 1
        assert len(c["source"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert harness.reader(m["name"]) is not None
        assert set(m.get("workloads", [])) <= {
            w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell, cfg, traffic, e2e, layer = harness.load_spec(w["name"])
        assert traffic["batch"] >= 1 and traffic["pool_batches"] >= 1
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_work_counts_by_hand():
    cfg = {"rows": 1000, "d": 8, "k": 10}
    nbytes, ops = work_flat.call_work(cfg, slice(0, 3))
    assert nbytes == 4 * 1000 * 8 + 4 * 3 * 8 + 12 * 3 * 10 == 32456
    assert ops == {"tf32": 2 * 3 * 1000 * 8}
    cfg = {"d": 16, "k": 2, "nlist": 4}
    detail = {"probes": np.array([[9, 9], [0, 1], [1, 3]]),
              "list_rows": np.array([5, 7, 0, 3])}
    nbytes, ops = work_ivf.call_work(cfg, slice(1, 3), detail)
    # lists 0, 1, 3 read once: 15 fp32 rows; the 4 centroids, 2 queries
    assert nbytes == 4 * 16 * (15 + 4 + 2) + 12 * 2 * 2 == 1392
    assert ops == {"tf32": 2 * 16 * (2 * 4 + (5 + 7) + (7 + 3))}
    assert bound_s(3.35e12, {"int8": 0})[1] == "bytes"
    assert bound_s(0, {"tf32": 495e12}) == (1.0, "operations")


def data_of(cfg_name: str, overrides: dict, seed: int = 5):
    cell = {"sift1m-idmap-flat": "sift1m-flat-b48",
            "sift1m-ivf4096-flat": "sift1m-ivf-b48"}[cfg_name]
    _, cfg, _, _, _ = harness.load_spec(cell)
    cfg = {**cfg, **overrides}
    return cfg, harness.part("data", cfg["generator"]).Data(
        cfg, seed, torch.device("cpu"))


def test_flat_reference_is_numpy_brute_force():
    cfg, data = data_of("sift1m-idmap-flat", TINY_FLAT)
    xb = np.concatenate([data.chunk(i).numpy()
                         for i, _ in data.chunk_sizes()]).astype(np.float64)
    xq = data.queries(40)
    ids = data.ids()
    d2 = ((xq.astype(np.float64)[:, None, :] - xb[None]) ** 2).sum(-1)
    order = np.argsort(d2, 1, kind="stable")[:, :cfg["k"]]
    sol = ref_flat.solve(cfg, data, xq, {}, np.array([0, 1]),
                         np.array([ids[order[0, 0]], -5]))
    np.testing.assert_allclose(sol.lo, -np.take_along_axis(d2, order, 1),
                               rtol=1e-12)
    assert (sol.lo == sol.hi).all()
    np.testing.assert_allclose(sol.want_score[0], -d2[0, order[0, 0]])
    assert sol.want_allowed.tolist() == [True, False]


@pytest.mark.parametrize("cfg_name,same_rows", [
    ("sift1m-idmap-flat", False), ("sift1m-ivf4096-flat", True)])
def test_the_corpus_follows_corpus_seed(cfg_name, same_rows):
    tiny = TINY_FLAT if cfg_name == "sift1m-idmap-flat" else TINY_IVF
    (_, a), (_, b) = (data_of(cfg_name, tiny, seed) for seed in (5, 6))
    assert torch.equal(a.chunk(1), b.chunk(1)) == same_rows
    assert not np.array_equal(a.queries(8), b.queries(8))
    assert not np.array_equal(a.ids(), b.ids())


def test_ivf_reference_is_numpy_brute_force():
    # a corpus on which no query's probes are in doubt, so that lo = hi
    cfg, data = data_of("sift1m-ivf4096-flat", {**TINY_IVF, "corpus_seed": 5})
    x = np.concatenate([data.chunk(i).numpy()
                        for i, _ in data.chunk_sizes()]).astype(np.float64)
    rng = np.random.default_rng(0)
    cent = x[rng.choice(len(x), cfg["nlist"], replace=False)]
    assign = ((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
    xq = data.queries(30)
    q64 = xq.astype(np.float64)
    d2 = ((q64[:, None, :] - x[None]) ** 2).sum(-1)
    probes = np.argsort(((q64[:, None, :] - cent[None]) ** 2).sum(-1),
                        1)[:, :cfg["nprobe"]]
    ids = data.ids()
    sol = ref_ivf.solve(cfg, data, xq, {"centroids": cent.astype(np.float32)},
                        np.array([0, 0]), np.array([ids[7], -5]))
    for i in range(len(xq)):
        inside = np.isin(assign, probes[i])
        want = -np.sort(d2[i][inside])[:cfg["k"]]
        np.testing.assert_allclose(sol.lo[i], want, rtol=1e-9)
        np.testing.assert_allclose(sol.hi[i], want, rtol=1e-9)
    np.testing.assert_allclose(sol.want_score[0], -d2[0, 7], rtol=1e-9)
    assert sol.want_allowed.tolist() == [assign[7] in probes[0], False]
    # recall's truth is the fp32 top 10: the float64 one to rounding
    truth = ids[np.argsort(d2, 1, kind="stable")[:, :cfg["k"]]]
    assert np.mean([len(set(a) & set(b)) for a, b in zip(sol.truth, truth)
                    ]) >= 0.97 * cfg["k"]
    # a table of random rows is far from a k-means fixed point
    assert sol.checks["kmeans_gain"][0] > 0.01
    assert sol.detail["assign_ties"] == 0


def test_probe_sets_by_hand():
    s = torch.tensor([[5.0, 4.0, 3.0, 2.99995, 1.0]], dtype=torch.float64)
    sure, may = ref_ivf.probe_sets(s, torch.full_like(s, 1e-4), 3)
    assert sure.tolist() == [[True, True, False, False, False]]
    assert may.tolist() == [[True, True, True, True, False]]
    cand, ok, ties = ref_ivf.possible_lists(s, torch.full_like(s, 1e-4))
    assert cand.tolist() == [[0, 1, 2]] and ok.tolist() == [[True, False,
                                                             False]]
    assert ties == 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0])
    got = common.to_tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sift1m-flat-b48",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def broken(monkeypatch, how: str):
    """Break the port's result path underneath the harness."""
    from duckdb_faiss_ext_tpu_torch.models import base

    real = base.fetch_results

    def fetch(dist, pos):
        d, p = real(dist, pos)
        d, p = d.copy(), p.copy()
        if how == "label":       # one answer altered where it is produced
            p[0, 0] = p[0, 1]
        elif how == "distance":
            d[-1, 3] *= np.float32(1.01)
        elif how == "half":      # half of the batch left out
            h = d.shape[0] // 2
            d[h:], p[h:] = d[:d.shape[0] - h], p[:d.shape[0] - h]
        return d, p

    monkeypatch.setattr(base, "fetch_results", fetch)


@pytest.mark.parametrize("how", [None, "label", "distance", "half"])
def test_a_broken_flat_path_is_not_correct(monkeypatch, how):
    if how:
        broken(monkeypatch, how)
    res, lines = harness.run_cell("sift1m-flat-b48", 3000000007, 0.3, False,
                                  device="cpu", overrides=TINY_FLAT)
    cmp = res["compared"]
    assert lines[-1].startswith("compared ") and list(res)[-1] == "compared"
    assert res["attempted"] > 0
    if how is None:
        assert res["correct"] and res["failed"] == 0, cmp
    else:
        assert not res["correct"] and res["failed"] > 0


def broken_ivf(monkeypatch, how: str):
    """Break the port's IVF training, assignment or probes underneath."""
    from duckdb_faiss_ext_tpu_torch.models import ivf

    from benchmark.systems import ivf_flat

    if how == "probe":       # one probe short of the configuration's
        monkeypatch.setattr(ivf_flat.System, "search",
                            ivf_flat.System.fault_search)
    elif how == "assign":    # every 8th row in its second nearest list
        real = ivf.IVFIndex._assign_candidates

        def assign(self, x):
            two = real(self, x, 2)
            return np.where(np.arange(len(two)) % 8 == 0, two[:, 1],
                            two[:, 0]).astype(np.int32)

        monkeypatch.setattr(ivf.IVFIndex, "_assign_lists", assign)
    elif how == "train":     # k-means returns the table it started from
        real_fit = ivf.kmeans_fit
        monkeypatch.setattr(ivf, "kmeans_fit",
                            lambda x, k, **kw: real_fit(x, k, **{
                                **kw, "niter": 0}))
    else:
        broken(monkeypatch, how)


@pytest.mark.parametrize("how", [None, "label", "half", "probe", "assign",
                                 "train"])
def test_a_broken_ivf_path_is_not_correct(monkeypatch, how):
    if how:
        broken_ivf(monkeypatch, how)
    res, _ = harness.run_cell("sift1m-ivf-b48", 3000000008, 0.3, False,
                              device="cpu", overrides=TINY_IVF)
    cmp = res["compared"]
    assert "recall_at_10" in res["metrics"] and "kmeans_gain" in cmp
    if how is None:
        assert res["correct"], cmp
    else:
        assert not res["correct"], cmp


@pytest.mark.parametrize("workload,overrides", [
    ("sift1m-flat-b48", TINY_FLAT), ("sift1m-ivf-b48", TINY_IVF)])
def test_the_control_fails_a_limit(workload, overrides):
    from benchmark import control

    out = control.readings(workload, 11, True, device="cpu",
                           overrides=overrides)
    _, cfg, _, _, _ = harness.load_spec(workload)
    lim = cfg["limits"]
    assert any(out["control"][n] > lim[n] for n in compare.NUMBERS), out
    assert out["program"]["bad_answers"] == 0
