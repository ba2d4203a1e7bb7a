"""Accuracy conformance run: recall vs a brute-force oracle + TREC output.

The local analogue of the reference's `make run_msmarco_queries` flow
(Makefile:98-99 → go/cmd/create_trec): build an index, run a query set at
k, score recall against the exact answer, optionally emit a TREC run file.
Uses a seeded synthetic corpus by default; pass --input/--queries
(.fvecs/.npy) for real corpora.

    python -m duckdb_faiss_ext_tpu_torch.tools.conformance \\
        --factory 'IVF1024,Flat' --nprobe 32 [--n 1000000 --d 128] \\
        [--trec run.txt] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness import recall_at_k, synthetic_dataset
from ..harness.datasets import load_fvecs
from ..harness.trec import write_trec_run
from ._cli import add_device_flag, select_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--factory", default="IVF1024,Flat")
    ap.add_argument("--metric", default="L2")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=None)
    ap.add_argument("--input", default=None, help=".fvecs/.npy corpus")
    ap.add_argument("--queries", default=None, help=".fvecs/.npy queries")
    ap.add_argument("--trec", default=None, help="write TREC run file here")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)

    if args.input:
        def load(p, m=None):
            return (load_fvecs(p, m) if p.endswith(".fvecs")
                    else np.load(p)[:m])

        xb = np.asarray(load(args.input, args.n), np.float32)
        xq = np.asarray(load(args.queries, args.nq), np.float32)
    else:
        xb, xq = synthetic_dataset(n=args.n, d=args.d, nq=args.nq)
    n, d = xb.shape
    print(f"corpus {n}×{d}, {xq.shape[0]} queries, index {args.factory}",
          file=sys.stderr)

    cat = Catalog()
    t0 = time.perf_counter()
    api.faiss_create("conf", d, args.factory, metric_type=args.metric,
                     catalog=cat)
    api.faiss_add(xb, "conf", catalog=cat)
    print(f"build: {time.perf_counter()-t0:.1f}s "
          f"({n/(time.perf_counter()-t0):.0f} vectors/s)", file=sys.stderr)

    api.faiss_create("oracle", d, "Flat", metric_type=args.metric,
                     catalog=cat)
    api.faiss_add(xb, "oracle", catalog=cat)
    gt = api.faiss_search("oracle", args.k, xq, catalog=cat)

    params = {"nprobe": str(args.nprobe)} if args.nprobe else None
    t0 = time.perf_counter()
    got = api.faiss_search("conf", args.k, xq, params, catalog=cat)
    qps = xq.shape[0] / (time.perf_counter() - t0)
    rec = recall_at_k(got["label"], gt["label"], args.k)
    print(f"recall@{args.k}: {rec:.4f}   qps: {qps:.1f}")

    if args.trec:
        write_trec_run(args.trec, "conf",
                       [str(i) for i in range(xq.shape[0])], xq, k=args.k,
                       params=params, catalog=cat)
        print(f"wrote {args.trec}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
