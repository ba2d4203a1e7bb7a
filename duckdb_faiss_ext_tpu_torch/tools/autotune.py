"""Autotune CLI: sweep an index's main search knob on synthetic data and
print the operating points (FAISS ParameterSpace/OperatingPoints analogue).

    python -m duckdb_faiss_ext_tpu_torch.tools.autotune [--n 200000] \\
        [--d 96] [--factory 'IVF1024,Flat'] [--k 10] [--target 0.9] \\
        [--nq 256] [--uniform] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness import autotune_index, synthetic_dataset
from ._cli import add_device_flag, select_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--factory", default="IVF1024,Flat")
    ap.add_argument("--metric", default="L2")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--ncl", type=int, default=1024,
                    help="gaussian-mixture cluster count of the corpus")
    ap.add_argument("--uniform", action="store_true",
                    help="uniform-random corpus instead of clustered")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)

    if args.uniform:
        rng = np.random.default_rng(42)
        xb = rng.standard_normal((args.n, args.d)).astype(np.float32)
        xq = rng.standard_normal((args.nq, args.d)).astype(np.float32)
    else:
        xb, xq = synthetic_dataset(n=args.n, d=args.d, nq=args.nq,
                                   ncl=args.ncl)
    print(f"corpus {args.n}x{args.d}, index {args.factory}", file=sys.stderr)
    cat = Catalog()
    api.faiss_create("tune", args.d, args.factory, metric_type=args.metric,
                     catalog=cat)
    api.faiss_add(xb, "tune", catalog=cat)
    res = autotune_index("tune", xq, k=args.k, target_recall=args.target,
                         catalog=cat)
    print(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
