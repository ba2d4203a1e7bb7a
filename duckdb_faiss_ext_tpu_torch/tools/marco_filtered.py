"""Three-strategy filtered search at the reference's own benchmark scale.

The reference's entire benchmark suite is filtered search over the
8,841,823-row ``ids`` table with ``sel = i % 100`` and pass rates 1-99%
(go/benches_c.go:31,124-201, go/main_test.go:18-51):

* post — faiss_search with the binomial-enlarged k', then the predicate;
* sel  — faiss_search_filter (bitmap selector);
* set  — faiss_search_filter_set (id-set selector).

This tool builds the MS MARCO stand-in's IVF4096,SQ8 inner-product index
on the card (tools/marco_device.py::build, assign_topk 4), registers the
id table and runs the harness's three-strategy sweep
(harness/filtered.py::run_filtered_bench, with the CPU column) in fast
mode, printing the JAX tool's table.  Beside it, for each pass rate and
strategy: the list scan the search took (the IVF model's
``_last_scan_path``, K2's k_scan and whether it is past the fused search's
limit), the spill search (K5 or the plain spill scan, which serves k above
128), the kernels launched by one call, and the seconds the predicate
takes over the table for the bitmap and for the id set (once a table
version: the selectors are cached).

``--config4`` runs the JAX tool's BASELINE config 4 instead: a 1M x 128
IVF4096,Flat L2 index by host ingest (``--n`` fewer rows, ``--nlist``),
``id%2==0``, post-filter at required_k(want, 0.5) against the two
selectors.

    python -m duckdb_faiss_ext_tpu_torch.tools.marco_filtered \\
        [--passrates 1,10,50,99] [--nq 48] [--nprobe 16] [--want 10] \\
        [--iters 3] [--config4] [--n 8841823] [--nlist 4096] [--cpu]

The JAX tool's queries were N(0, I) rows normalised; here they are drawn
from the corpus's serving mixture (``MarcoCorpus.queries``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness import required_k, run_filtered_bench, synthetic_dataset
from ..models.ivf_layout import choose_lmax
from ..ops.ivf_sq_scan import MAX_K as K2_MAX_K
from ..sql.engine import Database, default_database
from ..utils.config import set_precision
from ._cli import (describe_launches, launch_counts, launches_since,
                   select_device)
from .marco_device import NAME, add_build_flags, build

TABLE = "ids"


def describe_path(index, k: int, nprobe: int) -> str:
    """The list scan and spill search of the index's last search."""
    inner = getattr(index, "inner", index)
    path = getattr(inner, "_last_scan_path", None)
    plan = getattr(inner, "_layout_plan", lambda: None)()
    if getattr(inner, "sq_type", None) is not None and path == "per-query" \
            and plan:
        lmax = plan[1] or choose_lmax(int(inner._counts().max()))
        k_scan = inner._sq_kscan(k, nprobe * lmax)
        path += (f" (K2, k_scan {k_scan}: "
                 + ("raw launch + top-k)" if k_scan > K2_MAX_K
                    else "fused)"))
    spill = getattr(inner, "_last_spill_path", None)
    return f"{path}, spill {spill or 'none'}"


def run_sweep(name, xq, n, nprobe, passrates, want=10, iters=3,
              catalog: Catalog | None = None,
              database: Database | None = None, log=print):
    """The three strategies at each pass rate over ``name`` with the table
    ``ids`` (``id`` = 0..n-1) registered in ``database``; prints the JAX
    tool's table and each pass rate's paths.  Returns one dict a pass rate:
    ``result`` (the harness's FilteredBenchResult), ``predicate_s``
    (bitmap, id set), and for each strategy its path, its launches and the
    results of one call (``post``: the k' search, ``sel``, ``set``)."""
    db = database if database is not None else default_database()
    db.register(TABLE, {"id": np.arange(n, dtype=np.int64)})
    params = {"nprobe": str(nprobe)} if nprobe else None
    results = run_filtered_bench(name, xq, TABLE, "id", passrates=passrates,
                                 want=want, catalog=catalog, database=db,
                                 params=params, iters=iters,
                                 cpu_baseline=True)
    log(f"{'passrate':>9} {'k_req':>7} {'post_qps':>10} {'sel_qps':>10} "
        f"{'set_qps':>10} {'cpu_qps':>9}")
    for r in results:
        log(f"{r.passrate:9.2f} {r.required_k:7d} {r.qps_post:10.1f} "
            f"{r.qps_sel:10.1f} {r.qps_set:10.1f} {(r.qps_cpu or 0):9.2f}")
    index = api._cat(catalog).get(name).index
    rows = []
    for r in results:
        filt = f"id%100<{max(1, int(round(r.passrate * 100)))}"
        predicate = []
        for ev in (db.eval_filter_pair, db.eval_filter_ids):
            t0 = time.perf_counter()
            ev(TABLE, filt, "id")
            predicate.append(time.perf_counter() - t0)
        row = {"result": r, "predicate_s": tuple(predicate)}
        calls = {
            "post": (r.required_k, lambda: api.faiss_search(
                name, r.required_k, xq, params, catalog)),
            "sel": (want, lambda: api.faiss_search_filter(
                name, want, xq, filt, "id", TABLE, params, catalog,
                database=db)),
            "set": (want, lambda: api.faiss_search_filter_set(
                name, want, xq, filt, "id", TABLE, params, catalog,
                database=db)),
        }
        for key, (k, call) in calls.items():
            before = launch_counts()
            row[key] = call()
            row[f"{key}_launches"] = launches_since(before)
            row[f"{key}_path"] = describe_path(index, k, nprobe or 1)
        rows.append(row)
        log(f"  {r.passrate:.2f} ({filt}): predicate over {n} rows "
            f"{predicate[0]:.3f} s (bitmap) / {predicate[1]:.3f} s (id "
            f"set); " + "; ".join(
                f"{key} k={calls[key][0]}: {row[f'{key}_path']}, "
                f"{describe_launches(row[f'{key}_launches'])}"
                for key in calls))
    return rows


def config4(args) -> None:
    """BASELINE config 4: IVF4096,Flat L2 over 1M x 128 host-ingested
    rows, ``id%2==0``, post-filter at required_k(want, 0.5) against the
    bitmap and id-set selectors, best of ``--iters``."""
    n, d = min(args.n, 1_000_000), 128
    xb, xq = synthetic_dataset(n=n, d=d, nq=args.nq)
    ids = np.arange(n, dtype=np.int64)
    cat, db = Catalog(), Database()
    t0 = time.perf_counter()
    api.faiss_create("c4", d, f"IVF{args.nlist},Flat", metric_type="L2",
                     catalog=cat)
    api.faiss_add((ids, xb), "c4", catalog=cat)
    print(f"config4 build IVF{args.nlist},Flat {n}x{d}: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    db.register(TABLE, {"id": ids})
    params = {"nprobe": str(args.nprobe)}
    kp = required_k(args.want, 0.5)
    index = cat.get("c4").index

    def post():
        res = api.faiss_search("c4", kp, xq, params, catalog=cat)
        return res["label"] % 2 == 0

    def sel():
        return api.faiss_search_filter("c4", args.want, xq, "id%2==0", "id",
                                       TABLE, params, catalog=cat,
                                       database=db)

    def sset():
        return api.faiss_search_filter_set("c4", args.want, xq, "id%2==0",
                                           "id", TABLE, params, catalog=cat,
                                           database=db)

    for label, k, fn in ((f"post (k'={kp})", kp, post),
                         ("sel", args.want, sel), ("set", args.want, sset)):
        fn()
        before = launch_counts()
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        launched = {key: v // args.iters
                    for key, v in launches_since(before).items()}
        print(f"  config4 id%2==0 {label:14s}: {best * 1e3:7.1f} ms "
              f"({args.nq / best:7.1f} qps); "
              f"{describe_path(index, k, args.nprobe)}; a call: "
              f"{describe_launches(launched)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_build_flags(ap)
    ap.add_argument("--passrates", default="1,10,50,99")
    ap.add_argument("--nq", type=int, default=48)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--want", type=int, default=10)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--config4", action="store_true",
                    help="run only BASELINE config 4: 1M x 128 IVF4096, "
                         "id%%2==0 selector vs post-filter")
    args = ap.parse_args(argv)
    select_device(args)
    if args.config4:
        config4(args)
        print("MARCO-FILTERED COMPLETE", flush=True)
        return 0
    passrates = [int(p) / 100 for p in args.passrates.split(",")]
    cat, corpus, _ = build(args, log=lambda m: print(m, flush=True))
    xq = corpus.queries(args.nq)
    set_precision("fast")
    try:
        run_sweep(NAME, xq, args.n, args.nprobe, passrates, want=args.want,
                  iters=args.iters, catalog=cat, database=Database(),
                  log=lambda m: print(m, flush=True))
    finally:
        set_precision("parity")
    print("MARCO-FILTERED COMPLETE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
