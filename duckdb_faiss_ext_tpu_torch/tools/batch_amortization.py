"""The reference's batch-amortization claim, measured on the card.

README.md:87 (reference): "a batch of 48 queries is only ~25% slower than
a single query": per-batch latency grows slowly with the batch because a
fixed cost a call dominates.  This tool times ``faiss_search`` at b1 /
b48 / b256 / b1024 (best of 7, results on the host) and 16 x b48 through
``faiss_search_batched`` (mean of 3) for Flat and IVF4096,Flat (trained on
the first 262,144 rows, nprobe 64) L2 over ``synthetic_dataset(1_000_000,
128, nq=1024, seed=42)`` (BASELINE configs 2-3), in fast mode, and prints
both views: ms a batch with its ratio to b1 (the reference's claim) and
queries/s.

    python -m duckdb_faiss_ext_tpu_torch.tools.batch_amortization \\
        [--n 1000000] [--d 128] [--nlist 4096] [--train 262144] \\
        [--nprobe 64] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness.datasets import synthetic_dataset
from ..utils.config import set_precision
from ._cli import add_device_flag, select_device

BATCHES = (1, 48, 256, 1024)
K = 10


def best_ms(fn, iters=7):
    fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def amortization_table(cat, names, xq, params, *, k: int = K,
                       batches=BATCHES, iters: int = 7, log=print):
    """ms a batch, queries/s and the ratio to b1 for each index of
    ``names`` (``params`` its search parameters, in the same order) at each
    batch of the first rows of ``xq``, then 16 x b48 pipelined.  Returns
    one dict a row: ``index``, ``batch`` (an int, or "16xb48"), ``ms``,
    ``qps``, ``ratio`` (None for the pipelined row) and ``result`` (the
    search's last result)."""
    log(f"{'index':>6} {'batch':>9} {'ms/batch':>9} {'qps':>9} "
        f"{'vs b1 latency':>14}")
    rows = []
    for name, p in zip(names, params):
        base_ms = None
        for b in batches:
            q = xq[:b]
            out = {}

            def run(q=q, out=out):
                out["result"] = api.faiss_search(name, k, q, p, catalog=cat)

            t = best_ms(run, iters)
            base_ms = base_ms or t
            rows.append({"index": name, "batch": b, "ms": t,
                         "qps": b / t * 1e3, "ratio": t / base_ms,
                         "result": out["result"]})
            log(f"{name:>6} {b:>9} {t:9.3f} {b / t * 1e3:9.1f} "
                f"{t / base_ms:13.2f}x")
        big = xq[np.arange(16 * 48) % xq.shape[0]]
        api.faiss_search_batched(name, k, big, p, batch_size=48, catalog=cat)
        t0 = time.perf_counter()
        for _ in range(3):
            res = api.faiss_search_batched(name, k, big, p, batch_size=48,
                                           catalog=cat)
        dt = (time.perf_counter() - t0) / 3
        rows.append({"index": name, "batch": "16xb48", "ms": dt * 1e3 / 16,
                     "qps": big.shape[0] / dt, "ratio": None, "result": res})
        log(f"{name:>6} {'16xb48':>9} {dt * 1e3 / 16:9.3f} "
            f"{big.shape[0] / dt:9.1f} {'(pipelined)':>14}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--train", type=int, default=262_144,
                    help="IVF training rows (the corpus's first)")
    ap.add_argument("--nprobe", type=int, default=64)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)
    set_precision("fast")
    try:
        xb, xq = synthetic_dataset(args.n, args.d, nq=1024, seed=42)
        cat = Catalog()
        api.faiss_create("flat", args.d, "Flat", metric_type="L2",
                         catalog=cat)
        api.faiss_add(xb, "flat", catalog=cat)
        api.faiss_create("ivf", args.d, f"IVF{args.nlist},Flat",
                         metric_type="L2", catalog=cat)
        api.faiss_manual_train(xb[:args.train], "ivf", catalog=cat)
        api.faiss_add(xb, "ivf", catalog=cat)
        amortization_table(cat, ("flat", "ivf"), xq,
                           (None, {"nprobe": str(args.nprobe)}),
                           log=lambda m: print(m, flush=True))
    finally:
        set_precision("parity")
    print("BATCH-AMORTIZATION COMPLETE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
