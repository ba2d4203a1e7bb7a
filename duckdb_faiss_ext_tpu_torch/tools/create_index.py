"""Build and persist an index from an embedding file.

Port of the reference's create_index tool (go/cmd/create_index/main.go):
create → (manual train) → add → save, with the benchmark defaults
(IVF…/HNSW… factory strings, inner-product metric for MS MARCO ada2).

    python -m duckdb_faiss_ext_tpu_torch.tools.create_index \\
        --input emb.fvecs --output idx.dfx \\
        --factory 'IVF2048_HNSW128,Flat' --metric INNER_PRODUCT \\
        [--ids ids.npy] [--train-fraction 0.1] [--cpu]

Input formats: .fvecs (SIFT layout), .npy (n, d) float, .csv (id + dims).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness.datasets import load_fvecs
from ._cli import add_device_flag, parse_kv, select_device


def load_embeddings(path: str, max_rows=None):
    if path.endswith(".fvecs"):
        return None, load_fvecs(path, max_rows)
    if path.endswith(".npy"):
        x = np.load(path)
        return None, np.asarray(x[:max_rows], np.float32)
    raw = np.loadtxt(path, delimiter=",", dtype=np.float64)[:max_rows]
    return raw[:, 0].astype(np.int64), raw[:, 1:].astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--factory", default="IVF2048_HNSW128,Flat")
    ap.add_argument("--metric", default="INNER_PRODUCT")
    ap.add_argument("--ids", default=None, help=".npy int64 labels")
    ap.add_argument("--max-rows", type=int, default=None)
    ap.add_argument("--train-fraction", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=262_144)
    ap.add_argument("--params", default=None,
                    help="create params, e.g. efConstruction=128,foo=1")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)

    ids, x = load_embeddings(args.input, args.max_rows)
    if args.ids:
        ids = np.load(args.ids).astype(np.int64)
    n, d = x.shape
    print(f"loaded {n} × {d} vectors")

    cat = Catalog()
    api.faiss_create_params("build", d, args.factory, parse_kv(args.params),
                            metric_type=args.metric, catalog=cat)

    t0 = time.perf_counter()
    if args.train_fraction < 1.0:
        ntrain = max(1, int(n * args.train_fraction))
        api.faiss_manual_train(x[:ntrain], "build", catalog=cat)
        print(f"trained on {ntrain} rows in {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    for start in range(0, n, args.batch):
        chunk = slice(start, min(n, start + args.batch))
        data = (ids[chunk], x[chunk]) if ids is not None else x[chunk]
        api.faiss_add(data, "build", catalog=cat)
        print(f"  added {min(n, start + args.batch)}/{n}")
    dt = time.perf_counter() - t0
    print(f"added {n} rows in {dt:.1f}s ({n/dt:.0f} vectors/s)")

    api.faiss_save("build", args.output, catalog=cat)
    print(f"saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
