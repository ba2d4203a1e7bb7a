"""The pairs gate's measuring sweep: per-query against pair-tile IVF,SQ8.

For each (lmax, d) of the grid and each batch nq, a synthetic IVF,SQ8
layout (nlist lists, every list full at lmax rows of random codes, inner
product, unit-norm queries, ``nprobe`` random probes a query) is searched
at k 10 by the fused per-query search (K2, ops/ivf_sq_scan.py::
ivf_sq_list_search) and by the pair-tile search (K3, ops/ivf_sq_pairs.py::
ivf_sq_pairs_search, mega=False), with the k_scan the IVF model gives
them; with ``--flat`` the same over fp32 lists by K6 (ops/ivf_list_scan.py)
and K7 (ops/ivf_pairs.py).  Each is timed as the median of ``--reps`` calls, the two in turns
(per-query, pairs, pairs, per-query, ...), by CUDA events on the card and
by the host clock on the CPU.  The results must agree (labels equal where
the distances are apart).  Prints one row a shape in the format of
``ops/pairs_gate.py::MEASURED``: (lmax*d, nq, d, t_per_query / t_pairs).

    python -m duckdb_faiss_ext_tpu_torch.tools.pairs_crossover \\
        [--grid 512:128,2048:128,...] [--nqs 256,1024] [--nlist 1024] \\
        [--nprobe 16] [--reps 10] [--flat] [--cpu]

The JAX package's sweep (tools/pairs_profile.py --crossover) took the
same grid and settings on its TPU with a best of 3.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch

from ._cli import add_device_flag, select_device

#: (lmax, d) of the JAX package's crossover grid
GRID = ((512, 128), (2048, 128), (4096, 128), (1024, 768), (512, 1536),
        (1024, 1536), (2048, 1536))
K = 10


def layout(g, nlist, lmax, d, dev):
    """Full random sq8 lists: codes, rn, rs, counts, row_pos, vmin,
    scale."""
    codes = torch.randint(0, 256, (nlist, lmax, d), device=dev, generator=g,
                          dtype=torch.uint8)
    scale = torch.full((d,), 0.06 / 255, device=dev)
    vmin = torch.full((d,), -0.03, device=dev)
    c = codes.to(torch.float32)
    rn = ((c * scale) ** 2).sum(2)
    rs = c.sum(2)
    del c
    counts = torch.full((nlist,), lmax, dtype=torch.int32, device=dev)
    row_pos = torch.arange(nlist * lmax, dtype=torch.int32,
                           device=dev).reshape(nlist, lmax)
    return codes, rn, rs, counts, row_pos, vmin, scale


def timer(dev):
    if dev.type == "cuda":
        def ms(fn):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1)
    else:
        def ms(fn):
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)
    return ms


def in_turns(a, b, reps, ms):
    """Median ms of a and b, run in turns after one warm-up each."""
    a()
    b()
    ta, tb = [], []
    for r in range(reps):
        order = ((a, ta), (b, tb))
        for fn, out in (order if r % 2 == 0 else order[::-1]):
            out.append(ms(fn))
    return statistics.median(ta), statistics.median(tb)


def agree(got, want, tol=1e-5):
    """Whether two (scores, positions) results agree: scores within tol
    of the largest, positions equal where the scores are apart."""
    (gs, gp), (ws, wp) = got, want
    scale = float(ws.abs().max().clamp(min=1e-30))
    if float((gs - ws).abs().max()) > tol * scale:
        return False
    gap = (ws[:, 1:] - ws[:, :-1]).abs() > 2 * tol * scale
    sep = torch.ones_like(wp, dtype=torch.bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    return bool((gp[sep] == wp[sep]).all())


def searches(flat, g, nlist, nprobe, lmax, d, dev):
    """(per-query search, pair-tile search, kernel names) over one
    synthetic layout, each a function of (probe, xq): K2 / K3 over sq8
    codes, or with ``flat`` K6 / K7 over fp32 rows."""
    from ..ops.ivf_list_scan import ivf_list_search
    from ..ops.ivf_pairs import ivf_pairs_search
    from ..ops.ivf_sq_pairs import ivf_sq_pairs_search
    from ..ops.ivf_sq_scan import ivf_sq_list_search

    # the IVF model's rerank pools (IVFServe._sq_kscan for sq8, and the
    # Flat pair tiles' k_scan): the same rule for both
    k_scan = min(nprobe * lmax, max(4 * K, K + 32))
    kw = dict(k=K, metric="INNER_PRODUCT")
    if flat:
        rows = torch.randn(nlist, lmax, d, device=dev, generator=g)
        counts = torch.full((nlist,), lmax, dtype=torch.int32, device=dev)
        row_pos = torch.arange(nlist * lmax, dtype=torch.int32,
                               device=dev).reshape(nlist, lmax)
        return (lambda p, q: ivf_list_search(rows, counts, row_pos, p, q,
                                             None, **kw),
                lambda p, q: ivf_pairs_search(rows, counts, row_pos, p, q,
                                              None, k_scan=k_scan, **kw),
                ("K6", "K7"))
    codes, rn, rs, counts, row_pos, vmin, scale = layout(g, nlist, lmax, d,
                                                         dev)
    kw.update(k_scan=k_scan, codec="sq8")
    return (lambda p, q: ivf_sq_list_search(codes, rn, rs, counts, row_pos,
                                            p, q, None, vmin, scale, **kw),
            lambda p, q: ivf_sq_pairs_search(codes, rn, rs, counts, row_pos,
                                             p, q, None, vmin, scale,
                                             mega=False, **kw),
            ("K2", "K3"))


def measure(grid=GRID, nqs=(256, 1024), nlist=1024, nprobe=16, reps=10,
            seed=0, dev=None, flat=False, log=print):
    """MEASURED rows (lmax*d, nq, d, speedup) of the grid, each shape's
    times logged."""
    dev = dev or torch.device("cuda")
    ms = timer(dev)
    rows = []
    for lmax, d in grid:
        g = torch.Generator(device=dev).manual_seed(seed + lmax * d)
        per_query, pairs, names = searches(flat, g, nlist, nprobe, lmax,
                                           d, dev)
        for nq in nqs:
            xq = torch.nn.functional.normalize(
                torch.randn(nq, d, device=dev, generator=g), dim=1)
            probe = torch.randint(0, nlist, (nq, nprobe), device=dev,
                                  generator=g, dtype=torch.int32)
            if not agree(pairs(probe, xq), per_query(probe, xq)):
                raise RuntimeError(f"lmax {lmax} d {d} nq {nq}: the pair "
                                   f"tiles and the per-query search differ")
            t_q, t_p = in_turns(lambda: per_query(probe, xq),
                                lambda: pairs(probe, xq), reps, ms)
            rows.append((lmax * d, nq, d, round(t_q / t_p, 2)))
            log(f"lmax {lmax} d {d} nq {nq}: per-query ({names[0]}) "
                f"{t_q:.3f} ms, pair tiles ({names[1]}) {t_p:.3f} ms, "
                f"speedup {t_q / t_p:.3f}")
        del per_query, pairs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def parse_grid(text):
    return tuple(tuple(int(v) for v in p.split(":")) for p in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default=",".join(f"{l}:{d}" for l, d in GRID),
                    help="lmax:d pairs, comma-separated")
    ap.add_argument("--nqs", default="256,1024")
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flat", action="store_true",
                    help="time K6 against K7 over fp32 lists instead (the "
                         "gate's table is measured on sq8)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)
    dev = torch.device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        print("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    rows = measure(parse_grid(args.grid),
                   tuple(int(n) for n in args.nqs.split(",")), args.nlist,
                   args.nprobe, args.reps, args.seed, dev, args.flat,
                   log=lambda m: print(m, flush=True))
    print("MEASURED: list[tuple[int, int, int, float]] = [")
    for row in rows:
        print(f"    {row},")
    print("]")
    print("PAIRS-CROSSOVER COMPLETE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
