"""Two-process demo of the partitioned search.

    DFX_DEMO_PORT=29517 python -m duckdb_faiss_ext_tpu_torch.parallel.multihost_demo [--cpu] [--n N]

The command starts two worker processes (the same module with
``DFX_DEMO_RANK`` set) and waits for them.  Each worker joins the gloo
process group at ``localhost:$DFX_DEMO_PORT`` (a free port is picked when
the variable is unset), makes the same seeded corpus (n x d, L2), keeps
the rows that ``hash_partition`` gives its rank in an ``IDMap,Flat`` index
on the card (K1; on the CPU with ``--cpu``), searches the queries, and
sends its k-lists to rank 0, which merges them with the native merge
(``merge_host_topk``) and holds the merge against one process's search of
the whole corpus: labels equal wherever the distances are apart, distances
within 1e-5 of the batch's largest.  Rank 0 prints ``MULTIHOST OK`` when
they agree; the command's exit code is non-zero if any worker failed.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np

_TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _args(argv):
    p = argparse.ArgumentParser(prog="multihost_demo")
    p.add_argument("--cpu", action="store_true",
                   help="run the indexes on the CPU (default: the card)")
    p.add_argument("--n", type=int, default=1 << 20, help="corpus rows")
    p.add_argument("--d", type=int, default=128, help="dimensions")
    p.add_argument("--nq", type=int, default=48, help="queries")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--timeout", type=float, default=600,
                   help="seconds the workers may take")
    return p.parse_args(argv)


def _agree(got_d, got_l, ref_d, ref_l) -> bool:
    """Distances within _TOL of the batch's largest, labels equal wherever
    the neighbouring reference distances are further apart than that."""
    tol = _TOL * float(np.abs(ref_d[np.isfinite(ref_d)]).max())
    if not np.allclose(got_d, ref_d, rtol=0, atol=tol):
        return False
    gap = np.abs(np.diff(ref_d, axis=1)) > 2 * tol
    sep = np.ones_like(ref_l, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    return bool((got_l[sep] == ref_l[sep]).all())


def worker(rank: int, port: int, args) -> int:
    import torch.distributed as dist

    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.factory import build_index
    from duckdb_faiss_ext_tpu_torch.metrics import resolve_metric
    from duckdb_faiss_ext_tpu_torch.parallel.multihost import (
        init_multihost, local_rows, merge_host_topk)

    init_multihost(f"localhost:{port}", 2, rank)
    dt.set_device("cpu" if args.cpu else "cuda")
    rng = np.random.default_rng(args.seed)   # the same corpus in each rank
    xb = rng.standard_normal((args.n, args.d), dtype=np.float32)
    xq = rng.standard_normal((args.nq, args.d), dtype=np.float32)
    ids = np.arange(args.n, dtype=np.int64)
    own = local_rows(ids)
    metric = resolve_metric("L2")
    index = build_index(args.d, "IDMap,Flat", metric)
    index.add_with_ids(xb[own], ids[own])
    index.search(xq, args.k)                 # warm-up (first launch)
    t0 = time.perf_counter()
    res = index.search(xq, args.k)
    wall = 1e3 * (time.perf_counter() - t0)
    gathered = [None, None]
    dist.all_gather_object(gathered, (res.distances, res.labels, wall,
                                      int(own.sum())))
    ok = True
    if rank == 0:
        d, lab = merge_host_topk(np.stack([g[0] for g in gathered]),
                                 np.stack([g[1] for g in gathered]),
                                 metric.name, args.k)
        single = build_index(args.d, "IDMap,Flat", metric)
        single.add_with_ids(xb, ids)
        ref = single.search(xq, args.k)
        ok = _agree(d, lab, ref.distances, ref.labels)
        rows = [g[3] for g in gathered]
        walls = ", ".join(f"{g[2]:.3f}" for g in gathered)
        if ok:
            print(f"MULTIHOST OK: 2 processes over gloo, rows {rows} of "
                  f"{args.n} x {args.d} by hash_partition, {args.nq} queries "
                  f"k={args.k} on {'the CPU' if args.cpu else 'the card'}; "
                  f"the native merge of the ranks' k-lists equals one "
                  f"process's search (rank search walls {walls} ms)",
                  flush=True)
        else:
            print("MULTIHOST MISMATCH: the merged k-lists differ from the "
                  "single-process search", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    if "DFX_DEMO_RANK" in os.environ:
        return worker(int(os.environ["DFX_DEMO_RANK"]),
                      int(os.environ["DFX_DEMO_PORT"]), args)
    port = int(os.environ.get("DFX_DEMO_PORT") or _free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, DFX_DEMO_RANK=str(rank), DFX_DEMO_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "duckdb_faiss_ext_tpu_torch.parallel."
             "multihost_demo", *(sys.argv[1:] if argv is None else argv)],
            env=env))
    rc = 0
    deadline = time.monotonic() + args.timeout
    try:
        for p in procs:
            rc |= p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        rc = 124
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
