"""Headline benchmark of the port: Flat exact search QPS on one card at
SIFT1M scale, beside IVF4096.

    python3 -m duckdb_faiss_ext_tpu_torch.bench [--cpu] [--n N]

The workload of the JAX package's ``bench.py`` (its lines 1-30, 178-275):
a 1M x 128 fp32 clustered corpus (``harness.datasets.synthetic_dataset``,
seed 42, queries drawn near its clusters), k = 10, through the public API
in fast mode:

* ``Flat`` L2: ``faiss_search`` at b48 (the headline) and b1024, and the
  pipelined serving path, 16 x b48 through ``faiss_search_batched``;
* ``IVF4096,Flat`` L2 trained on the first 262,144 rows, every row added,
  ``faiss_search`` at nprobe 64 at b48 and b1024, and recall@10 of the b48
  batch against the Flat results.

A rate is the best of three groups of timed calls (host clock around calls
that return their results on the host).  The CPU denominator is pinned: a
numpy BLAS scan (sgemm + partial select) over a fixed 131,072-row
subsample, best of three groups of five batches, extrapolated to the
corpus rows; ``vs_baseline`` = b48 QPS / ``cpu_qps``, both in the line.

Prints ONE JSON line to stdout with the keys of ``bench.py``'s line
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``pipelined_qps``,
``ivf_qps``, ``ivf_qps_b1024``, ``ivf_recall``) plus ``cpu_qps``,
``device`` (``torch.cuda.get_device_name``, or "cpu") and ``card``
(nvidia-smi's name and power limit); progress goes to stderr.  It runs on
the card and fails without one; ``--cpu`` (with a small ``--n``, which
trains min(262,144, n) rows into a list per 64 of them, at most 4096)
runs the same steps on the CPU for tests.  Any failure, the IVF part's included,
fails the bench.  Not ported from ``bench.py``: the relay's probes
(round trip, compute, ``device_alive``), the cached last-good line and
the chip lock.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

D, K = 128, 10
BATCH, BIG_BATCH, PIPELINE = 48, 1024, 16
N, NLIST, TRAIN, NPROBE = 1_000_000, 4096, 262_144, 64
BASELINE_SUBSAMPLE, BASELINE_GROUPS, BASELINE_ITERS = 131_072, 3, 5


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str | None:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def best_qps(search, nq, iters=10, groups=3) -> float:
    """Queries/s of ``search()`` over ``nq`` queries: one warm-up call,
    then the best of ``groups`` timed groups of ``iters`` calls."""
    search()
    best = 0.0
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(iters):
            search()
        best = max(best, nq * iters / (time.perf_counter() - t0))
    return best


def cpu_baseline_qps(n_rows: int) -> float:
    """The pinned CPU denominator: b48 queries/s of a numpy BLAS exact
    scan over BASELINE_SUBSAMPLE seeded rows, extrapolated to ``n_rows``."""
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((BASELINE_SUBSAMPLE, D), dtype=np.float32)
    xq = rng.standard_normal((BATCH, D), dtype=np.float32)
    xb_norms = (xb * xb).sum(axis=1)

    def run():
        d = xb_norms[None, :] - 2.0 * (xq @ xb.T)
        idx = np.argpartition(d, K, axis=1)[:, :K]
        part = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(part, axis=1)
        return np.take_along_axis(idx, order, axis=1)

    run()
    best = float("inf")
    for _ in range(BASELINE_GROUPS):
        t0 = time.perf_counter()
        for _ in range(BASELINE_ITERS):
            run()
        best = min(best, (time.perf_counter() - t0) / BASELINE_ITERS)
    return BATCH / (best * n_rows / BASELINE_SUBSAMPLE)


def run(n: int) -> dict:
    """The workload over an n-row corpus; returns the JSON line."""
    import torch

    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.harness import (recall_at_k,
                                                    synthetic_dataset)
    from duckdb_faiss_ext_tpu_torch.utils.config import resolve_device

    on_card = resolve_device().type == "cuda"   # raises without a card
    train = min(TRAIN, n)
    nlist = min(NLIST, max(1, train // 64))
    dt.set_precision("fast")
    device = torch.cuda.get_device_name(0) if on_card else "cpu"
    card = card_line() if on_card else None
    log(f"device {device} [{card}]")
    xb, xq_all = synthetic_dataset(n, D, nq=BATCH + BIG_BATCH, seed=42)
    xq, xq_big = xq_all[:BATCH], xq_all[BATCH:]
    cat = dt.Catalog()

    def search(name, queries, params=None):
        return lambda: dt.faiss_search(name, K, queries, params, catalog=cat)

    dt.faiss_create("bench", D, "Flat", metric_type="L2", catalog=cat)
    t0 = time.perf_counter()
    dt.faiss_add(xb, "bench", catalog=cat)
    dt.faiss_search("bench", K, xq[:8], catalog=cat)
    log(f"flat add + upload: {n / (time.perf_counter() - t0):.0f} vectors/s")
    qps48 = best_qps(search("bench", xq), BATCH)
    qps_big = best_qps(search("bench", xq_big), BIG_BATCH, iters=5)
    log(f"flat qps b{BATCH}: {qps48:.1f}; b{BIG_BATCH}: {qps_big:.1f}")
    piped = np.tile(xq, (PIPELINE, 1))
    qps_pipe = best_qps(lambda: dt.faiss_search_batched(
        "bench", K, piped, batch_size=BATCH, catalog=cat), piped.shape[0],
        iters=3)
    log(f"flat qps pipelined {PIPELINE} x b{BATCH}: {qps_pipe:.1f}")

    ivf = {"nprobe": str(NPROBE)}
    dt.faiss_create("bench_ivf", D, f"IVF{nlist},Flat", metric_type="L2",
                    catalog=cat)
    t0 = time.perf_counter()
    dt.faiss_manual_train(xb[:train], "bench_ivf", catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add(xb, "bench_ivf", catalog=cat)
    dt.faiss_search("bench_ivf", K, xq[:8], ivf, catalog=cat)
    log(f"ivf train ({nlist} lists, {train} rows): {t_train:.1f} s; add + "
        f"layout: {time.perf_counter() - t0:.1f} s")
    qps_ivf = best_qps(search("bench_ivf", xq, ivf), BATCH)
    qps_ivf_big = best_qps(search("bench_ivf", xq_big, ivf), BIG_BATCH,
                           iters=5)
    recall = recall_at_k(search("bench_ivf", xq, ivf)()["label"],
                         search("bench", xq)()["label"], K)
    log(f"ivf qps b{BATCH} nprobe={NPROBE}: {qps_ivf:.1f}; b{BIG_BATCH}: "
        f"{qps_ivf_big:.1f}; recall@{K} {recall:.3f}")

    cpu_qps = cpu_baseline_qps(n)
    log(f"cpu baseline qps ({BASELINE_SUBSAMPLE} rows, scaled to {n}): "
        f"{cpu_qps:.1f}")
    return {
        "metric": "flat_search_qps_sift1m_k10_b48",
        "value": qps48,
        "unit": "queries/s/chip",
        "vs_baseline": qps48 / cpu_qps,
        "pipelined_qps": qps_pipe,
        "ivf_qps": qps_ivf,
        "ivf_qps_b1024": qps_ivf_big,
        "ivf_recall": recall,
        "cpu_qps": cpu_qps,
        "flat_qps_b1024": qps_big,
        "n": n,
        "device": device,
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--n", type=int, default=N, help="corpus rows")
    args = ap.parse_args(argv)
    if args.cpu:
        from duckdb_faiss_ext_tpu_torch import set_device

        set_device("cpu")
    line = run(args.n)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
