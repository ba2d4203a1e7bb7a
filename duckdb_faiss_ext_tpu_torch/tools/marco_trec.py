"""Full-scale TREC conformance: k=1000 over the 8.8M index built on the
card.

The reference's accuracy-conformance flow runs TREC-DL19 topics at k=1000
against the full 8,841,823-doc index and emits a TREC run file
(go/cmd/create_trec/main.go:32-48, Makefile:98-99).  Real MS MARCO qrels
cannot be fetched here, so the qrels are graded from exact search: each
query's exact top-10 over the corpus (tools/marco_corpus.py, drawn again
on the card) becomes 3 grade-3 and 7 grade-2 judgments, and the run is
scored with trec_eval's conventions (MRR@10, nDCG@10, recall@1000).

k=1000 reaches the top-k and rerank widths the serving sweeps do not: on
IVF,SQ the scan keeps k_scan > 1024 candidates, past the fused kernels'
limit, so the search takes the raw list and pair-tile launches.

    python -m duckdb_faiss_ext_tpu_torch.tools.marco_trec [--storage SQ8] \\
        [--nprobe 64] [--k 1000] [--nq 256] [--out logs/marco_trec.run] \\
        [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..harness.trec import score_trec_run, write_trec_run
from ..utils.config import set_precision
from . import marco_device
from ._cli import select_device


def graded_qrels(qids, exact) -> dict:
    """{qid: {docid: grade}}: grade 3 for a query's 3 nearest rows, 2 for
    the next 7 (make_synthetic_qrels's first two grades)."""
    return {qid: {str(int(doc)): 3 if r < 3 else 2
                  for r, doc in enumerate(row[:10])}
            for qid, row in zip(qids, exact)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    marco_device.add_build_flags(ap)
    ap.add_argument("--nprobe", type=int, default=64)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256,
                    help="queries a search call of the run")
    ap.add_argument("--out", default="logs/marco_trec.run")
    args = ap.parse_args(argv)
    select_device(args)
    set_precision("fast")
    try:
        cat, corpus, _ = marco_device.build(args)
        xq = corpus.queries(args.nq)
        qids = [str(i) for i in range(args.nq)]
        qrels = graded_qrels(qids, corpus.exact_ip_labels(xq, 10, args.n))
        params = {"nprobe": str(args.nprobe)}
        print(f"\n=== TREC k={args.k} over {args.n} rows ({args.storage} "
              f"np{args.nprobe}) ===", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        t0 = time.perf_counter()
        write_trec_run(args.out, marco_device.NAME, qids, xq, k=args.k,
                       run_name=f"dfx-{args.storage.lower()}", params=params,
                       catalog=cat, batch=args.batch)
        sec = time.perf_counter() - t0
    finally:
        set_precision("parity")
    print(f"run written: {args.out} ({args.nq} queries x k={args.k} in "
          f"{sec:.1f}s = {args.nq / sec:.1f} qps at k={args.k})", flush=True)
    scores = score_trec_run(args.out, qrels, recall_k=args.k)
    print("TREC scores: " + "  ".join(
        f"{m}={v:.4f}" if isinstance(v, float) else f"{m}={v}"
        for m, v in scores.items()), flush=True)
    print("MARCO-TREC COMPLETE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
