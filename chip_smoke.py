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
   have launched the kernel; then kernel and plain version are timed;
6. IVF sweep: the per-query list scan (K6, ops/ivf_list_scan.py) and the
   pair-tile scan (K7, ops/ivf_pairs.py) against their plain versions on
   the card, raw scores element by element: L2 and inner product, with and
   without a mask, nprobe 1 / 3 / 64, d 8 / 128 / 1536, lmax 256 and 1024
   (counts on both sides of 256, 512 and 768), lists of count 0 and
   count == lmax, pair tiles with dead slots and n_tiles < t_max;
7. IVF main path: IDMap,IVF4096,Flat L2 over the same corpus
   (BASELINE.json configs[2]): faiss_manual_train on its first 262,144
   rows → faiss_add of all 1M with ids → faiss_search at nprobe 64 at b48
   and b1024, faiss_search_batched 16 x b48, faiss_search_filter.  Every
   result is held against the plain list scan on the same layout (labels
   equal where distances are separated), the kernel launch counts must
   match the calls, and recall@10 against exact Flat is printed; K6's and
   K7's raw scores at b1024 are held against their plain versions; then
   K6 is timed against its plain version, K7 against K6 and the top-k of
   the score block alone at b1024, and faiss_search wall time is taken;
8. pair-tile path: IVF1024,Flat inner product over 262,144 x 1536
   (seed 7) at nprobe 16: b1024 goes through K7 by the static gate and
   b48 through K6, both held against the plain path; K7's raw tiles at
   b1024 are held against its plain version, then timed against it.

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
IVF_LIST_KERNEL = {
    "name": "ivf_list_scan",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_list_scan.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf.py:63",
}
IVF_PAIRS_KERNEL = {
    "name": "ivf_pairs",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_pairs.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py:748",
}
#: IVF main path (bench.py:231-271, BASELINE.json configs[2]): IVF4096
#: trained on the first 262,144 rows, searched at nprobe 64
IVF_TRAIN, IVF_NPROBE = 262_144, 64
#: pair-tile path at the ada-002 width of the reference's MS MARCO corpus,
#: rows cut from 8.8M
PAIRS_N, PAIRS_D, PAIRS_NLIST, PAIRS_NPROBE = 262_144, 1536, 1024, 16

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


def main_path_data():
    """The 1M x 128 clustered corpus (seed 42) and its query batches, shared
    by the Flat and IVF main paths."""
    t0 = time.perf_counter()
    xb, xq_all = synthetic_dataset(N, D, nq=BATCH + BIG_BATCH, seed=42)
    data = {"xb": xb, "ids": np.arange(N, dtype=np.int64),
            "b48": xq_all[:BATCH], "b1024": xq_all[BATCH:],
            "batched": xq_all[:BATCH * N_BATCHES]}
    log(f"main path: corpus {N}x{D} generated "
        f"({time.perf_counter() - t0:.1f} s)")
    return data


def phase_main_path(smi, data):
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu_torch.utils.config import (config, next_pow2,
                                                          pad_rows)

    xb, ids = data["xb"], data["ids"]
    xq48, xq1024, xq_batched = data["b48"], data["b1024"], data["batched"]
    db = dt.Database()
    db.register("base", {"id": ids})
    cat = dt.Catalog()

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
    exact = {name: out[name]["label"] for name in ("b48", "b1024")}
    return max_err, launches, timings, exact


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


def compare_raw(got, want, qn):
    """Raw score blocks (rows, slots) of a kernel and its plain version, on
    the card: -inf slots agree exactly, every other score to REL_TOL of its
    row's scale (the larger of its largest |score| and |q|^2).  Returns
    the max abs error."""
    finite = torch.isfinite(want)
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          "-inf slots differ")
    check(bool(torch.isfinite(got[finite]).all()), "non-finite score")
    if not bool(finite.any()):
        return 0.0
    tol = REL_TOL * torch.maximum(
        torch.where(finite, want.abs(), 0.0).amax(1), qn)
    diff = torch.where(finite, (got - want).abs(), 0.0)
    err = float(diff.max())
    check(bool((diff <= tol[:, None]).all()), f"score error {err} above "
          f"tolerance")
    return err


def k6_raw_error(lists, counts, probe, xq, mask, metric):
    """K6's raw (nq, nprobe, lmax) scores against its plain version on the
    same card tensors."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6

    raw = k6.ivf_list_scan(lists, counts, probe, xq, mask, metric)
    ref = k6.ivf_list_scan_reference(lists, counts, probe, xq, mask, metric)
    nq, nprobe, lmax = raw.shape
    qn = (xq * xq).sum(1)[:, None].expand(nq, nprobe)
    return compare_raw(raw.reshape(-1, lmax), ref.reshape(-1, lmax),
                       qn.reshape(-1))


def k7_raw_error(lists, counts, xq_t, qs_t, meta, mask, metric):
    """K7's raw (t_max, qg, lmax) tiles against its plain version on the
    same card tensors, over the n_tiles real tiles (the kernel leaves the
    rest unwritten)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    raw = k7.ivf_pairs_scan(lists, counts, xq_t, qs_t, meta, mask, metric)
    ref = k7.ivf_pairs_scan_reference(lists, counts, xq_t, qs_t, meta, mask,
                                      metric)
    n_tiles, lmax = int(meta[0]), raw.shape[2]
    return compare_raw(raw[:n_tiles].reshape(-1, lmax),
                       ref[:n_tiles].reshape(-1, lmax),
                       qs_t[:n_tiles, :, 1].reshape(-1))


def probe_table(g, nq, nlist, nprobe):
    """Distinct random lists per query; query 0 probes list 0 (empty) and
    query 1 list 1 (full) first."""
    keys = torch.rand(nq, nlist, device=DEVICE, generator=g)
    keys[0, 0] = keys[1, 1] = -1.0
    return keys.argsort(1)[:, :nprobe].to(torch.int32).contiguous()


def phase_ivf_sweep():
    """K6 and K7 against their plain versions: L2 / IP, mask off / on,
    nprobe 1 / 3 / 64, d 8 / 128 / 1536, lmax 256 and 1024 (counts on both
    sides of each 256-row chunk edge of K7), lists of count 0 and count ==
    lmax, K7 with dead slots and n_tiles < t_max."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    g = torch.Generator(device=DEVICE).manual_seed(4321)
    nlist, nq6, nq7 = 64, BATCH, 256
    before = (k6.LAUNCHES, k7.LAUNCHES)
    err6 = err7 = 0.0
    n_cases = 0
    for d, lmax in itertools.product(SWEEP_D, (256, 1024)):
        t0 = time.perf_counter()
        counts = torch.randint(1, lmax, (nlist,), device=DEVICE, generator=g,
                               dtype=torch.int32)
        counts[0], counts[1] = 0, lmax
        if lmax > 256:
            counts[2:8] = torch.tensor([255, 257, 511, 513, 767, 769])
        lane = torch.arange(lmax, device=DEVICE)
        lists = torch.randn(nlist, lmax, d, device=DEVICE, generator=g)
        lists *= (lane[None, :] < counts[:, None])[:, :, None]
        mask = (torch.rand(nlist, lmax, device=DEVICE, generator=g)
                < 0.6).to(torch.int8)
        xq = torch.randn(nq7, d, device=DEVICE, generator=g)
        for metric, m, nprobe in itertools.product(
                ("L2", "INNER_PRODUCT"), (None, mask), (1, 3, 64)):
            probe = probe_table(g, nq7, nlist, nprobe)
            err6 = max(err6, k6_raw_error(lists, counts,
                                          probe[:nq6].contiguous(),
                                          xq[:nq6].contiguous(), m, metric))
            xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq, nlist)
            check(int(meta[0]) < xq_t.shape[0], "no padding tiles")
            check(bool(torch.isneginf(qs_t[:int(meta[0]), :, 0]).any())
                  or nprobe * nq7 % k7.QG == 0, "no dead slots")
            err7 = max(err7, k7_raw_error(lists, counts, xq_t, qs_t, meta, m,
                                          metric))
            n_cases += 1
        log(f"ivf sweep d={d} lmax={lmax}: 12 cases x (K6, K7) agree "
            f"({time.perf_counter() - t0:.1f} s)")
        del lists, mask, xq
        torch.cuda.empty_cache()
    check((k6.LAUNCHES - before[0], k7.LAUNCHES - before[1])
          == (n_cases, n_cases), "an ivf sweep case did not launch")
    log(f"ivf sweep: {n_cases} cases each, max abs score error K6 "
        f"{err6:.3g}, K7 {err7:.3g}")
    return err6, err7


def plain_ivf_search(index, xq, k, nprobe, mask=None):
    """The IVF,Flat search of ``index`` (no IDMap) through the plain list
    scan on the same device layout: the coarse top-nprobe on the batch
    padded as the index pads it, K6's plain version, top-k, positions.
    Returns (distances, storage ids) as numpy."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import (exact_topk,
                                                            finalize_scores)
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.utils.config import (config, next_pow2,
                                                          pad_rows)

    lay = index._build_device_layout()
    nq = xq.shape[0]
    nq_pad = max(config.min_query_bucket, next_pow2(nq))
    xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(DEVICE)
    metric = index.metric.name
    probe = coarse_topk(xq_pad, lay.centroids, nprobe, metric)[:nq]
    raw = k6.ivf_list_scan_reference(lay.payload, lay.counts,
                                     probe.contiguous(), xq_pad[:nq], mask,
                                     metric)
    lmax = lay.payload.shape[1]
    best, sel = exact_topk(raw.reshape(nq, -1), k)
    pos = lay.row_pos[probe.long().gather(1, sel // lmax), sel % lmax]
    dist, pos = finalize_scores(best, pos, metric)
    pos = pos.cpu().numpy()
    return dist.cpu().numpy(), np.where(pos >= 0, index._ids[pos], -1)


def compare_results(name, res, ref_dist, ref_labels, similarity):
    """A public-API result against the plain path, computed one wider so
    the k-th label is checked only where the (k+1)-th distance is apart
    from it: distances within REL_TOL of the batch's largest, labels equal
    wherever the neighbouring distances are further apart than that.
    Returns the max abs error."""
    k = res["label"].shape[1]
    check(ref_labels.shape[1] == k + 1, f"{name}: plain path not one wider")
    finite = np.isfinite(ref_dist[:, :k])
    check(np.array_equal(np.isfinite(res["distance"]), finite),
          f"{name}: missing slots differ")
    tol = REL_TOL * float(np.abs(ref_dist[np.isfinite(ref_dist)]).max())
    err = float(np.abs(np.where(finite, res["distance"], 0)
                       - np.where(finite, ref_dist[:, :k], 0)).max())
    check(err <= tol, f"{name}: distance error {err} > {tol}")
    key = np.where(np.isfinite(ref_dist),
                   -ref_dist if similarity else ref_dist, np.inf)
    gap = np.abs(np.diff(key, axis=1)) > 2 * tol
    sep = finite & gap[:, :k]
    sep[:, 1:] &= gap[:, :k - 1]
    bad = np.argwhere(sep & (res["label"] != ref_labels[:, :k]))
    check(not bad.size, f"{name}: labels differ at {bad[:5].tolist()}")
    return err


def phase_ivf_main(smi, data, exact):
    """IDMap,IVF4096,Flat L2 over the 1M x 128 corpus at nprobe 64, through
    the public API; every result held against the plain path."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.utils.config import pad_rows

    xb, ids = data["xb"], data["ids"]
    db = dt.Database()
    db.register("base", {"id": ids})
    cat = dt.Catalog()
    params = {"nprobe": str(IVF_NPROBE)}
    t0 = time.perf_counter()
    dt.faiss_create("ivf", D, "IDMap,IVF4096,Flat", metric_type="L2",
                    catalog=cat)
    dt.faiss_manual_train(xb[:IVF_TRAIN], "ivf", catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add((ids, xb), "ivf", catalog=cat)
    t_add = time.perf_counter() - t0
    index = cat.get("ivf").index.inner
    t0 = time.perf_counter()
    lay = index._build_device_layout()
    t_layout = time.perf_counter() - t0
    check(index._layout_plan() == ("full", None), "no full layout plan")
    lmax = lay.payload.shape[1]
    log(f"ivf main path: train {t_train:.2f} s, add {t_add:.2f} s, layout "
        f"build+upload {t_layout:.2f} s; lmax {lmax}, longest list "
        f"{int(lay.counts.max())}")

    k6.LAUNCHES = k7.LAUNCHES = 0
    out = {
        "b48": dt.faiss_search("ivf", K, data["b48"], params, catalog=cat),
        "b1024": dt.faiss_search("ivf", K, data["b1024"], params,
                                 catalog=cat),
        "batched": dt.faiss_search_batched("ivf", K, data["batched"], params,
                                           batch_size=BATCH, catalog=cat),
        "filter": dt.faiss_search_filter("ivf", K, data["b48"], "id%2==0",
                                         "id", "base", params, catalog=cat,
                                         database=db),
    }
    launches = (k6.LAUNCHES, k7.LAUNCHES)
    calls = [(64, 1), (BIG_BATCH, 1), (64, N_BATCHES), (64, 1)]
    expected = (sum(n for nq, n in calls if not index.pairs_wanted(nq, lmax)),
                sum(n for nq, n in calls if index.pairs_wanted(nq, lmax)))
    check(launches == expected, f"ivf main path launched (K6, K7) "
          f"{launches} times, not {expected}")
    check(index.device.type == DEVICE, "index not on the card")
    log(f"ivf main path: (K6, K7) launches {launches}")

    even = ((lay.row_pos >= 0) & (lay.row_pos % 2 == 0)).to(torch.int8)
    max_err = 0.0
    for name, xq, m in (("b48", data["b48"], None),
                        ("b1024", data["b1024"], None),
                        ("batched", data["batched"], None),
                        ("filter", data["b48"], even)):
        # The plain path runs each batch as the index ran it (batched:
        # 48 queries at a time), so the coarse top-k sees the same shapes.
        step = BATCH if name == "batched" else xq.shape[0]
        parts = [plain_ivf_search(index, xq[s:s + step], K + 1, IVF_NPROBE,
                                  m)
                 for s in range(0, xq.shape[0], step)]
        ref_d = np.concatenate([p[0] for p in parts])
        ref_l = np.concatenate([p[1] for p in parts])
        res = out[name]
        check(np.isfinite(res["distance"]).all(), f"{name}: non-finite")
        max_err = max(max_err, compare_results(f"ivf {name}", res, ref_d,
                                               ref_l, False))
        if m is not None:
            check((res["label"] % 2 == 0).all(), "filter: odd label")
        recall = (np.mean([len(set(a) & set(b)) / K for a, b in
                           zip(res["label"], exact[name])])
                  if name in exact else float("nan"))
        log(f"ivf main path {name}: {xq.shape[0]} queries agree with the "
            f"plain path (max distance error {max_err:.3g}); recall@10 vs "
            f"exact Flat {recall:.4f}")

    timings = {}
    for name in ("b48", "b1024"):
        xq = data[name]
        nq_pad = 64 if name == "b48" else BIG_BATCH
        xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(DEVICE)
        probe = coarse_topk(xq_pad, lay.centroids, IVF_NPROBE, "L2")
        args = (lay.payload, lay.counts, probe, xq_pad, None, "L2")
        ms, plain_ms = time_pair(lambda: k6.ivf_list_scan(*args),
                                 lambda: k6.ivf_list_scan_reference(*args))
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            dt.faiss_search("ivf", K, xq, params, catalog=cat)
            walls.append(1e3 * (time.perf_counter() - t0))
        timings[name] = (ms, plain_ms)
        log(f"time IVF4096 {N}x{D} L2 nprobe {IVF_NPROBE} {name} ({nq_pad} "
            f"rows launched): K6 {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"(median CUDA events); faiss_search wall "
            f"{statistics.median(walls):.3f} ms (median) [{smi}]")
        if name == "b1024":
            search = dict(k=K, metric="L2")
            lists = (lay.payload, lay.counts, lay.row_pos, probe, xq_pad, None)
            k7_ms, k6_ms = time_pair(
                lambda: k7.ivf_pairs_search(*lists, k_scan=max(4 * K, K + 32),
                                            **search),
                lambda: k6.ivf_list_search(*lists, **search), reps=6)
            xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq_pad,
                                                      lay.payload.shape[0])
            raw_err6 = k6_raw_error(*args)
            raw_err7 = k7_raw_error(lay.payload, lay.counts, xq_t, qs_t,
                                    meta, None, "L2")
            log(f"ivf main path b1024 raw scores (lmax {lmax}): K6 and K7 "
                f"agree with their plain versions (max abs error K6 "
                f"{raw_err6:.3g}, K7 {raw_err7:.3g})")
            raw = k6.ivf_list_scan(*args).reshape(BIG_BATCH, -1)
            exact_topk(raw, K)
            topk_ms = statistics.median(
                cuda_ms(lambda: exact_topk(raw, K)) for _ in range(6))
            del raw
            log(f"time IVF4096 {N}x{D} L2 nprobe {IVF_NPROBE} b1024: top-k "
                f"of the raw score block alone {topk_ms:.3f} ms (median "
                f"CUDA events) [{smi}]")
            raw7_ms, raw6_ms = time_pair(
                lambda: k7.ivf_pairs_scan(lay.payload, lay.counts, xq_t,
                                          qs_t, meta, None, "L2"),
                lambda: k6.ivf_list_scan(*args), reps=6)
            log(f"time IVF4096 {N}x{D} L2 nprobe {IVF_NPROBE} b1024, K7 "
                f"pair tiles against K6 per query: scan + top-k "
                f"{k7_ms:.3f} vs {k6_ms:.3f} ms, raw scores only "
                f"{raw7_ms:.3f} vs {raw6_ms:.3f} ms (median CUDA events) "
                f"[{smi}]")
    return max(max_err, raw_err6), raw_err7, launches[0], timings


def clustered_f32(n, d, nq, ncl, seed):
    """Clustered corpus + queries near its clusters, drawn in float32."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d), dtype=np.float32) * 4.0
    xb = centers[rng.integers(0, ncl, n)]
    xb += rng.standard_normal((n, d), dtype=np.float32)
    xq = centers[rng.integers(0, ncl, nq)]
    xq += rng.standard_normal((nq, d), dtype=np.float32)
    return xb, xq


def phase_ivf_pairs(smi):
    """IVF1024,Flat IP over 262,144 x 1536 at nprobe 16: b1024 takes the
    pair tiles (K7) by the static gate, b48 the per-query scan (K6)."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk

    t0 = time.perf_counter()
    xb, xq = clustered_f32(PAIRS_N, PAIRS_D, BATCH + BIG_BATCH, PAIRS_NLIST,
                           seed=7)
    cat = dt.Catalog()
    params = {"nprobe": str(PAIRS_NPROBE)}
    dt.faiss_create("marco", PAIRS_D, f"IVF{PAIRS_NLIST},Flat",
                    metric_type="INNER_PRODUCT", catalog=cat)
    dt.faiss_manual_train(xb, "marco", catalog=cat)
    dt.faiss_add(xb, "marco", catalog=cat)
    index = cat.get("marco").index
    lay = index._build_device_layout()
    lmax = lay.payload.shape[1]
    log(f"ivf pairs path: {PAIRS_N}x{PAIRS_D} built in "
        f"{time.perf_counter() - t0:.1f} s; lmax {lmax}")
    check(index.pairs_wanted(BIG_BATCH, lmax), "the gate does not take the "
          "pair tiles at b1024")
    k6.LAUNCHES = k7.LAUNCHES = 0
    out = {"b1024": dt.faiss_search("marco", K, xq[BATCH:], params,
                                    catalog=cat),
           "b48": dt.faiss_search("marco", K, xq[:BATCH], params,
                                  catalog=cat)}
    launches = (k6.LAUNCHES, k7.LAUNCHES)
    check(launches == (1, 1), f"pairs path launched (K6, K7) {launches}")
    max_err = 0.0
    for name, q in (("b1024", xq[BATCH:]), ("b48", xq[:BATCH])):
        ref_d, ref_l = plain_ivf_search(index, q, K + 1, PAIRS_NPROBE)
        max_err = max(max_err, compare_results(
            f"pairs {name}", out[name], ref_d, ref_l, True))
    log(f"ivf pairs path: b1024 through K7 and b48 through K6 agree with "
        f"the plain path (max distance error {max_err:.3g})")

    xq_dev = torch.from_numpy(xq[BATCH:]).to(DEVICE)
    probe = coarse_topk(xq_dev, lay.centroids, PAIRS_NPROBE, "INNER_PRODUCT")
    xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq_dev, PAIRS_NLIST)
    args = (lay.payload, lay.counts, xq_t, qs_t, meta, None, "INNER_PRODUCT")
    raw_err = k7_raw_error(*args)
    log(f"ivf pairs path b1024 raw tiles ({int(meta[0])} of {xq_t.shape[0]} "
        f"tiles, lmax {lmax}): K7 agrees with its plain version (max abs "
        f"error {raw_err:.3g})")
    ms, plain_ms = time_pair(lambda: k7.ivf_pairs_scan(*args),
                             lambda: k7.ivf_pairs_scan_reference(*args),
                             reps=6)
    log(f"time IVF{PAIRS_NLIST} {PAIRS_N}x{PAIRS_D} IP nprobe {PAIRS_NPROBE} "
        f"b1024 ({int(meta[0])} of {xq_t.shape[0]} tiles): K7 {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (median CUDA events) [{smi}]")
    lists = (lay.payload, lay.counts, lay.row_pos, probe, xq_dev, None)
    search = dict(k=K, metric="INNER_PRODUCT")
    k7_ms, k6_ms = time_pair(
        lambda: k7.ivf_pairs_search(*lists, k_scan=max(4 * K, K + 32),
                                    **search),
        lambda: k6.ivf_list_search(*lists, **search), reps=6)
    log(f"time IVF{PAIRS_NLIST} {PAIRS_N}x{PAIRS_D} IP nprobe {PAIRS_NPROBE} "
        f"b1024 scan + top-k: K7 pair tiles {k7_ms:.3f} ms, K6 per query "
        f"{k6_ms:.3f} ms (median CUDA events) [{smi}]")
    return max(max_err, raw_err), launches[1], (ms, plain_ms)


def main():
    smi = phase_environment()
    phase_build()
    sweep_err = phase_sweep()
    golden_err = phase_golden()
    data = main_path_data()
    main_err, launches, timings, exact = phase_main_path(smi, data)
    phase_time_1536(smi)
    err6, err7 = phase_ivf_sweep()
    ivf_err, ivf_err7, ivf_launches, ivf_timings = phase_ivf_main(smi, data,
                                                                  exact)
    del data
    torch.cuda.empty_cache()
    pairs_err, pairs_launches, pairs_timing = phase_ivf_pairs(smi)
    log(smi)
    ms, plain_ms = timings["b48"]
    ivf_ms, ivf_plain_ms = ivf_timings["b48"]
    print(json.dumps({"kernels": [
        dict(KERNEL, launches=launches,
             max_abs_err=max(sweep_err, golden_err, main_err),
             ms=ms, plain_ms=plain_ms),
        dict(IVF_LIST_KERNEL, launches=ivf_launches,
             max_abs_err=max(err6, ivf_err), ms=ivf_ms,
             plain_ms=ivf_plain_ms),
        dict(IVF_PAIRS_KERNEL, launches=pairs_launches,
             max_abs_err=max(err7, ivf_err7, pairs_err),
             ms=pairs_timing[0],
             plain_ms=pairs_timing[1]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
