"""Chip smoke test of duckdb_faiss_ext_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: a CUDA card must be visible; prints nvidia-smi's name and
   power limit;
2. build: compiles the package's CUDA sources (csrc/*.cu) with nvcc;
3. kernel sweep: the fused distance + top-k kernel (ops/flat_topk.py)
   against its plain torch version on the same card tensors, TF32 off:
   L2 and inner product, nq in {1, 48, 64, 1024}, k in {1, 10, 100, 1024},
   with and without a row mask, nvalid < capacity, d in {8, 128, 1536} at
   1M rows (the 1536-d corpus is 6 GB, generated on the card from a seeded
   generator), plus duplicated rows that must rank by ascending position;
4. golden parity: the reference's test corpus (tests/data) through the
   public API on the card reproduces its 20 golden inner-product distances,
   labels and filtered results;
5. main path: IDMap,Flat L2 over a 1M x 128 clustered corpus (seed 42):
   faiss_create → faiss_add → faiss_search at b48 and b1024 (k=10) →
   faiss_search_batched 16 x b48 → faiss_search_filter('id%2==0') over a
   registered 1M-row table.  Every result is checked against the plain
   version (recall@10 = 1.0, distances within tolerance) and the path must
   have launched the kernel; then kernel and plain version are timed.

The last two lines of standard output are a JSON object describing each
kernel and the JSON result line {"ok": true, "device": {...}}.
"""

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N, D, K = 1_000_000, 128, 10
BATCH, BIG_BATCH, N_BATCHES = 48, 1024, 16
SWEEP_D = (8, 128, 1536)
SWEEP_NQ = (1, 48, 64, 1024)   # 64: b48 as the Flat model launches it
SWEEP_K = (1, 10, 100, 1024)
#: kernel sweep: scores agree to 1e-5 of the query's scale (fp32 sums taken
#: in another order, see compare); main path: distances to 1e-5 of the
#: batch's largest distance.  Positions agree wherever the neighbouring
#: scores are further apart than that.
REL_TOL = 1e-5
KERNEL = {
    "name": "flat_topk",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/flat_topk.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_topk.py:40",
}

# test/sql/faiss.test:16-38 of the reference: k=2 IP distances per query.
GOLDEN_FLAT_DISTANCES = [
    2.3337207, 2.2165565, 3.5882926, 3.336133, 4.2489142, 4.133893,
    3.3984408, 3.1702023, 2.8143706, 2.7383637, 3.7191334, 3.6072645,
    2.866281, 2.8265002, 4.5306416, 4.3778625, 4.809322, 4.7254314,
    5.233301, 5.0149097,
]
# test/sql/faiss3.test:22-45: (rank 0, rank 1) labels per query.
GOLDEN_LABELS = [
    (374, 59), (374, 676), (768, 880), (374, 623), (374, 623),
    (59, 880), (999, 904), (374, 676), (880, 955), (943, 374),
]
# test/sql/faiss3.test:46-68: faiss_search_filter with column0>100.
GOLDEN_FILTERED = [
    (374, 2.33372), (676, 2.17094), (374, 3.58829), (676, 3.33613),
    (768, 4.24891), (880, 4.13389), (374, 3.39844), (623, 3.1702),
    (374, 2.81437), (623, 2.73836), (880, 3.60726), (374, 3.60568),
    (999, 2.86628), (904, 2.8265), (374, 4.53064), (676, 4.37786),
    (880, 4.80932), (955, 4.72543), (943, 5.2333), (374, 5.01491),
]


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_dataset(n, d, nq, ncl=1024, seed=42):
    """Clustered corpus + queries drawn near its clusters (the JAX
    package's harness.datasets.synthetic_dataset, as bench.py uses it)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 4.0
    xb = (centers[rng.integers(0, ncl, n)]
          + rng.standard_normal((n, d)).astype(np.float32))
    xq = (centers[rng.integers(0, ncl, nq)]
          + rng.standard_normal((nq, d)).astype(np.float32))
    return xb, xq


def compare(scores, pos, ref_scores, ref_pos, xq):
    """Max abs score error after checking the kernel's k (score, position)
    pairs against the plain version's, computed one wider so the k-th
    position is checked only when the (k+1)-th score is apart from it;
    raises on disagreement.  Each query's tolerance is REL_TOL times the
    larger of its largest |score| and |q|^2 (the scale of the terms an L2
    score cancels)."""
    s, p, rs, rp = (t.cpu().numpy() for t in (scores, pos, ref_scores,
                                                ref_pos))
    k = s.shape[1]
    beyond = rs[:, k:k + 1]
    rs, rp = rs[:, :k], rp[:, :k]
    finite = np.isfinite(rs)
    check(np.array_equal(np.isfinite(s), finite), "missing slots differ")
    check(np.array_equal(p[~finite], rp[~finite]), "missing positions differ")
    if not finite.any():
        return 0.0
    qn = (xq * xq).sum(1).cpu().numpy()
    tol = REL_TOL * np.maximum(np.abs(np.where(finite, rs, 0)).max(1), qn)
    diff = np.abs(np.where(finite, s - rs, 0))
    check((diff <= tol[:, None]).all(),
          f"score error {diff.max()} above tolerance")
    ext = np.concatenate([rs, beyond], 1) if beyond.size else rs
    far = (np.abs(np.diff(np.where(np.isfinite(ext), ext, -1e30), axis=1))
           > 2 * tol[:, None])
    separated = np.ones_like(finite)
    separated[:, 1:] &= far[:, :k - 1]
    separated[:, :-1] &= far[:, :k - 1]
    if beyond.size:
        separated[:, -1] &= far[:, -1]
    bad = np.argwhere(separated & (p != rp))
    if bad.size:
        q = bad[0, 0]
        log(f"query {q}: kernel {p[q][:12].tolist()} {s[q][:12].tolist()}")
        log(f"query {q}: plain  {rp[q][:12].tolist()} {rs[q][:12].tolist()}")
    check(not bad.size, f"positions differ at {bad[:5].tolist()}")
    return float(diff.max())


def cuda_ms(fn):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def time_pair(kernel_fn, plain_fn, reps=10):
    """Median CUDA-event ms of kernel and plain version, run in turns
    (plain, kernel, kernel, plain, ...) after one warm-up each."""
    kernel_fn()
    plain_fn()
    kt, pt = [], []
    for r in range(reps):
        order = ((plain_fn, pt), (kernel_fn, kt))
        for fn, out in (order if r % 2 == 0 else order[::-1]):
            out.append(cuda_ms(fn))
    return statistics.median(kt), statistics.median(pt)


def phase_environment():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from duckdb_faiss_ext_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    kernels.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds:.2f} s)")


def phase_sweep():
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.utils.config import next_capacity

    g = torch.Generator(device=DEVICE).manual_seed(1234)
    cap = next_capacity(N)               # the Flat index's bucket for N rows
    before = ft.LAUNCHES
    max_err, n_cases = 0.0, 0
    dups = [10, N // 3, N // 2, N - 1]   # duplicated rows
    for d in SWEEP_D:
        xb = torch.randn(cap, d, device=DEVICE, generator=g)
        # The tie row: a norm of 10·sqrt(d) puts it first for both
        # metrics when it is also the query.
        tie = torch.randn(d, device=DEVICE, generator=g)
        tie *= 10 * d ** 0.5 / tie.norm()
        xb[dups] = tie
        mask = torch.rand(cap, device=DEVICE, generator=g) < 0.5
        mask[dups] = True
        queries = torch.randn(max(SWEEP_NQ), d, device=DEVICE, generator=g)
        queries[:4] = tie
        t0 = time.perf_counter()
        for metric, nq, k, m in itertools.product(
                ("L2", "INNER_PRODUCT"), SWEEP_NQ, SWEEP_K, (None, mask)):
            xq = queries[:nq].contiguous()
            s, p = ft.flat_topk(xb, N, xq, k, metric, m)
            torch.cuda.synchronize()
            rs, rp = ft.flat_topk_reference(xb, N, xq, k + 1, metric, m)
            max_err = max(max_err, compare(s, p, rs, rp, xq))
            n_cases += 1
            if k >= len(dups):
                ties = p[:min(nq, 4), :len(dups)].cpu().tolist()
                check(ties == [dups] * len(ties), f"tie order {ties}")
        log(f"sweep d={d}: {2 * len(SWEEP_NQ) * len(SWEEP_K) * 2} cases "
            f"agree ({time.perf_counter() - t0:.1f} s)")
        del xb, mask, queries
        torch.cuda.empty_cache()
    check(ft.LAUNCHES - before == n_cases, "a sweep case did not launch")
    log(f"sweep: {n_cases} cases, max abs score error {max_err:.3g}")
    return max_err


def phase_golden():
    import duckdb_faiss_ext_tpu_torch as dt

    def load(name):
        raw = np.loadtxt(os.path.join(HERE, "tests", "data", name),
                         delimiter=",", dtype=np.float64)
        return raw[:, 0].astype(np.int64), raw[:, 1:].astype(np.float32)

    ids, xb = load("training.csv")
    _, xq = load("queries.csv")
    cat = dt.Catalog()
    dt.faiss_create("flat8", 8, "Flat", catalog=cat)
    dt.faiss_add(xb, "flat8", catalog=cat)
    check(catalog_device(cat, "flat8") == DEVICE, "index not on the card")
    res = dt.faiss_search("flat8", 2, xq, catalog=cat)
    err = np.abs(res["distance"].reshape(-1) - GOLDEN_FLAT_DISTANCES)
    np.testing.assert_allclose(res["distance"].reshape(-1),
                               GOLDEN_FLAT_DISTANCES, rtol=2e-6)
    dt.faiss_create("flat82", 8, "IDMap,Flat", catalog=cat)
    dt.faiss_add((ids, xb), "flat82", catalog=cat)
    res = dt.faiss_search("flat82", 2, xq, catalog=cat)
    np.testing.assert_array_equal(res["label"], np.array(GOLDEN_LABELS))
    db = dt.Database()
    db.register("training", {"column0": ids})
    gl, gd = zip(*GOLDEN_FILTERED)
    for fn in (dt.faiss_search_filter, dt.faiss_search_filter_set):
        res = fn("flat82", 2, xq, "column0>100", "column0", "training",
                 catalog=cat, database=db)
        np.testing.assert_array_equal(res["label"].reshape(-1), gl)
        np.testing.assert_allclose(res["distance"].reshape(-1), gd, rtol=1e-4)
    log(f"golden: 20 distances (max rel err "
        f"{float((err / np.abs(GOLDEN_FLAT_DISTANCES)).max()):.3g}), labels "
        f"and filtered results reproduced on the card")
    return float(err.max())


def catalog_device(cat, name):
    index = cat.get(name).index
    return getattr(index, "inner", index).device.type


def phase_main_path(smi):
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu_torch.utils.config import (config, next_pow2,
                                                          pad_rows)

    t0 = time.perf_counter()
    xb, xq_all = synthetic_dataset(N, D, nq=BATCH + BIG_BATCH, seed=42)
    ids = np.arange(N, dtype=np.int64)
    xq48, xq1024 = xq_all[:BATCH], xq_all[BATCH:]
    xq_batched = xq_all[:BATCH * N_BATCHES]
    db = dt.Database()
    db.register("base", {"id": ids})
    cat = dt.Catalog()
    log(f"main path: corpus {N}x{D} generated "
        f"({time.perf_counter() - t0:.1f} s)")

    ft.LAUNCHES = 0
    t0 = time.perf_counter()
    dt.faiss_create("sift", D, "IDMap,Flat", metric_type="L2", catalog=cat)
    dt.faiss_add((ids, xb), "sift", catalog=cat)
    t_add = time.perf_counter() - t0
    out = {
        "b48": dt.faiss_search("sift", K, xq48, catalog=cat),
        "b1024": dt.faiss_search("sift", K, xq1024, catalog=cat),
        "batched": dt.faiss_search_batched("sift", K, xq_batched,
                                           batch_size=BATCH, catalog=cat),
        "filter": dt.faiss_search_filter("sift", K, xq48, "id%2==0", "id",
                                         "base", catalog=cat, database=db),
    }
    launches = ft.LAUNCHES
    expected = 1 + 1 + -(-xq_batched.shape[0] // BATCH) + 1
    check(launches == expected,
          f"main path launched the kernel {launches} times, not {expected}")
    check(catalog_device(cat, "sift") == DEVICE, "index not on the card")
    log(f"main path: create+add {t_add:.2f} s; {launches} kernel launches")

    index = cat.get("sift").index.inner
    corpus = index.device_vectors()
    even = torch.from_numpy(ids % 2 == 0).to(DEVICE)
    even = torch.cat([even, torch.zeros(corpus.shape[0] - N, dtype=torch.bool,
                                        device=DEVICE)])
    max_err = 0.0
    for name, xq, m in (("b48", xq48, None), ("b1024", xq1024, None),
                        ("batched", xq_batched, None), ("filter", xq48, even)):
        res = out[name]
        xq_dev = torch.from_numpy(xq).to(DEVICE)
        rd, rp = finalize_scores(*ft.flat_topk_reference(
            corpus, N, xq_dev, K, "L2", m), "L2")
        ref_labels = ids[rp.cpu().numpy()]
        ref_dist = rd.cpu().numpy()
        check(res["label"].shape == (xq.shape[0], K), f"{name}: shape")
        check(np.isfinite(res["distance"]).all(), f"{name}: non-finite")
        recall = np.mean([len(set(a) & set(b)) / K for a, b in
                          zip(res["label"], ref_labels)])
        check(recall == 1.0, f"{name}: recall@10 {recall}")
        tol = REL_TOL * float(np.abs(ref_dist).max())
        err = float(np.abs(res["distance"] - ref_dist).max())
        check(err <= tol, f"{name}: distance error {err} > {tol}")
        if m is not None:
            check((res["label"] % 2 == 0).all(), "filter: odd label returned")
        max_err = max(max_err, err)
        log(f"main path {name}: {xq.shape[0]} queries, recall@10 vs plain "
            f"{recall:.4f}, max distance error {err:.3g}")

    timings = {}
    for name, xq in (("b48", xq48), ("b1024", xq1024)):
        # Timed at the shape the Flat model launches: queries padded to its
        # power-of-two bucket (b48 → 64 rows).
        nq_pad = max(config.min_query_bucket, next_pow2(xq.shape[0]))
        xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(DEVICE)
        ms, plain_ms = time_pair(
            lambda: ft.flat_topk(corpus, N, xq_pad, K, "L2"),
            lambda: ft.flat_topk_reference(corpus, N, xq_pad, K, "L2"))
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            dt.faiss_search("sift", K, xq, catalog=cat)
            walls.append(1e3 * (time.perf_counter() - t0))
        timings[name] = (ms, plain_ms)
        log(f"time {N}x{D} L2 k={K} {name} ({nq_pad} rows launched): "
            f"kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (median CUDA events); faiss_search wall "
            f"{statistics.median(walls):.3f} ms (median) [{smi}]")
    return max_err, launches, timings


def phase_time_1536(smi):
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft

    from duckdb_faiss_ext_tpu_torch.utils.config import next_capacity

    g = torch.Generator(device=DEVICE).manual_seed(99)
    xb = torch.randn(next_capacity(N), 1536, device=DEVICE, generator=g)
    for nq in (BATCH, BIG_BATCH):
        xq = torch.randn(nq, 1536, device=DEVICE, generator=g)
        ms, plain_ms = time_pair(
            lambda: ft.flat_topk(xb, N, xq, K, "INNER_PRODUCT"),
            lambda: ft.flat_topk_reference(xb, N, xq, K, "INNER_PRODUCT"),
            reps=6)
        log(f"time {N}x1536 IP k={K} b{nq}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (median CUDA events) [{smi}]")


def main():
    smi = phase_environment()
    phase_build()
    sweep_err = phase_sweep()
    golden_err = phase_golden()
    main_err, launches, timings = phase_main_path(smi)
    phase_time_1536(smi)
    ms, plain_ms = timings["b48"]
    log(smi)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches,
        max_abs_err=max(sweep_err, golden_err, main_err),
        ms=ms, plain_ms=plain_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
