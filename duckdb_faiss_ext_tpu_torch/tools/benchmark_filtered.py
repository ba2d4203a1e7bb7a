"""Three-strategy filtered-search benchmark CLI.

Port of the reference's `make benchmark` flow (go/main_test.go:18-51): for
each passrate, compare post-filtering (enlarged k' from the binomial CDF)
against the bitmap and id-set selector strategies.

    python -m duckdb_faiss_ext_tpu_torch.tools.benchmark_filtered \\
        [--n 1000000] [--d 128] [--factory 'IVF4096,Flat'] [--nprobe 64] \\
        [--passrates 1,10,50,99] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness import run_filtered_bench, synthetic_dataset
from ..sql import Database
from ._cli import add_device_flag, select_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--nq", type=int, default=48)
    ap.add_argument("--factory", default="IDMap,Flat")
    ap.add_argument("--metric", default="L2")
    ap.add_argument("--nprobe", type=int, default=None)
    ap.add_argument("--passrates", default="1,10,50,99",
                    help="percent, comma-separated (reference sweeps 1-99)")
    ap.add_argument("--want", type=int, default=10)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)

    xb, xq = synthetic_dataset(n=args.n, d=args.d, nq=args.nq)
    ids = np.arange(args.n, dtype=np.int64)
    print(f"corpus {args.n}×{args.d}, index {args.factory}", file=sys.stderr)

    cat, db = Catalog(), Database()
    api.faiss_create("bench", args.d, args.factory, metric_type=args.metric,
                     catalog=cat)
    api.faiss_add((ids, xb), "bench", catalog=cat)
    db.register("t", {"id": ids})

    params = {"nprobe": str(args.nprobe)} if args.nprobe else None
    passrates = [int(p) / 100 for p in args.passrates.split(",")]
    results = run_filtered_bench("bench", xq, "t", "id",
                                 passrates=passrates, want=args.want,
                                 catalog=cat, database=db, params=params)
    print(f"{'passrate':>9} {'k_req':>7} {'post_qps':>10} {'sel_qps':>10} "
          f"{'set_qps':>10}")
    for r in results:
        print(f"{r.passrate:9.2f} {r.required_k:7d} {r.qps_post:10.1f} "
              f"{r.qps_sel:10.1f} {r.qps_set:10.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
