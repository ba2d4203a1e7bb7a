"""Run a query set against a saved index and emit a TREC run file.

Port of the reference's create_trec tool (go/cmd/create_trec/main.go:32-48):
the accuracy-conformance flow scored externally against qrels.

    python -m duckdb_faiss_ext_tpu_torch.tools.create_trec --index idx.dfx \\
        --queries q.npy --qids qids.txt --output run.trec --k 1000 \\
        [--params nprobe=15] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness.datasets import load_fvecs
from ..harness.trec import write_trec_run
from ._cli import add_device_flag, parse_kv, select_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--queries", required=True, help=".npy or .fvecs")
    ap.add_argument("--qids", default=None,
                    help="text file, one query id per line")
    ap.add_argument("--output", required=True)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--run-name", default="dfx-tpu")
    ap.add_argument("--params", default=None, help="e.g. nprobe=15")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)

    q = (load_fvecs(args.queries) if args.queries.endswith(".fvecs")
         else np.load(args.queries).astype(np.float32))
    if args.qids:
        with open(args.qids) as f:
            qids = f.read().split()
    else:
        qids = [str(i) for i in range(q.shape[0])]

    cat = Catalog()
    api.faiss_load("trec", args.index, catalog=cat)
    write_trec_run(args.output, "trec", qids, q, k=args.k,
                   run_name=args.run_name, params=parse_kv(args.params),
                   catalog=cat)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
