"""Frozen synthetic "marco-mini" accuracy-conformance flow.

The reference's accuracy flow (`make run_msmarco_queries`, Makefile:73-99)
builds an index over MS MARCO ada2 embeddings, runs TREC DL19 topics at
k=1000 through create_trec (go/cmd/create_trec/main.go:32-48), and scores
the run file with anserini-tools.  This tool freezes a deterministic
synthetic stand-in — same shape class (default 100k × 1536 clustered,
seeded), qrels graded from an exact search — and drives the same five-step
flow end to end:

    generate → create_index (train+add+save) → faiss_load →
    create_trec (k=1000 run file) → score_trec_run (MRR@10 / nDCG@10 /
    recall@1000)

Usage:
    python -m duckdb_faiss_ext_tpu_torch.tools.marco_mini [--n 100000]
        [--d 1536] [--nq 128] [--factory IVF1024,Flat] [--params nprobe=15]
        [--workdir DIR] [--cpu]

The same flow runs at small scale in tests/test_torch_trec_flow.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..harness.datasets import synthetic_dataset
from ..harness.trec import (make_synthetic_qrels, read_qrels, score_trec_run,
                            write_qrels)
from . import create_index, create_trec
from ._cli import add_device_flag, select_device


def generate(workdir: str, n: int, d: int, nq: int, seed: int = 9,
             metric: str = "INNER_PRODUCT") -> tuple:
    """Write corpus.npy / queries.npy / qids.txt / qrels.txt (frozen by
    seed).  Queries are drawn near corpus clusters like the real MARCO
    topics sit near passages."""
    xb, xq = synthetic_dataset(n, d, nq, ncl=max(64, n // 128), seed=seed)
    if metric == "INNER_PRODUCT":
        # MARCO ada2 embeddings are unit-norm; IP == cosine there.
        xb /= np.linalg.norm(xb, axis=1, keepdims=True)
        xq /= np.linalg.norm(xq, axis=1, keepdims=True)
    qids = [str(100 + i) for i in range(nq)]
    np.save(os.path.join(workdir, "corpus.npy"), xb)
    np.save(os.path.join(workdir, "queries.npy"), xq)
    with open(os.path.join(workdir, "qids.txt"), "w") as f:
        f.write("\n".join(qids) + "\n")
    qrels = make_synthetic_qrels(xb, xq, qids, metric=metric)
    write_qrels(os.path.join(workdir, "qrels.txt"), qrels)
    return xb, xq, qids, qrels


def run_flow(workdir: str, factory: str, params: str | None,
             metric: str = "INNER_PRODUCT", k: int = 1000,
             train_fraction: float = 0.25, cpu: bool = False) -> dict:
    """create_index → load → create_trec → score, via the tools' mains."""
    idx_path = os.path.join(workdir, "marco_mini.dfx")
    run_path = os.path.join(workdir, "run.trec")
    device = ["--cpu"] if cpu else []
    argv = ["--input", os.path.join(workdir, "corpus.npy"),
            "--output", idx_path, "--factory", factory, "--metric", metric,
            "--train-fraction", str(train_fraction)] + device
    if create_index.main(argv) != 0:
        raise RuntimeError("create_index failed")
    argv = ["--index", idx_path,
            "--queries", os.path.join(workdir, "queries.npy"),
            "--qids", os.path.join(workdir, "qids.txt"),
            "--output", run_path, "--k", str(k),
            "--run-name", "marco-mini"] + device
    if params:
        argv += ["--params", params]
    if create_trec.main(argv) != 0:
        raise RuntimeError("create_trec failed")
    qrels = read_qrels(os.path.join(workdir, "qrels.txt"))
    return score_trec_run(run_path, qrels, recall_k=k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=1536)
    ap.add_argument("--nq", type=int, default=128)
    ap.add_argument("--factory", default="IVF1024,Flat")
    ap.add_argument("--params", default="nprobe=15")
    ap.add_argument("--metric", default="INNER_PRODUCT")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--seed", type=int, default=9)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)

    workdir = args.workdir or tempfile.mkdtemp(prefix="marco_mini_")
    os.makedirs(workdir, exist_ok=True)
    print(f"workdir {workdir}")
    t0 = time.time()
    generate(workdir, args.n, args.d, args.nq, seed=args.seed,
             metric=args.metric)
    print(f"generated {args.n}x{args.d} + qrels in {time.time() - t0:.1f}s")
    scores = run_flow(workdir, args.factory, args.params, args.metric,
                      cpu=args.cpu)
    print(json.dumps({"factory": args.factory, "params": args.params,
                      **{k: round(v, 4) for k, v in scores.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
