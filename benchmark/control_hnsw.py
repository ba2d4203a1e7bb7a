"""The readings that the HNSW cell's limits are set from: control.py's,
with the efSearch fault judged by the reference's checks as well.

    python3 benchmark/control_hnsw.py --seeds 1,2 [--forward 1]
        [--workload marco-hnsw128-b48]

For each seed, in one process: the cell's set-up, one call of every pool
batch through the port at the configuration's ``ef_search`` and at its
``fault_ef_search`` (``fault_search``: FAISS's default efSearch 16), the
index freed, then the plain reference.  The port's answers, the fault's
and the control's (control.py's: the reference's exact search with its
products in TF32) are judged as a run judges them, and the port's and the
fault's also with the reference's checks (``recall_miss``,
``unreachable``), which control.py's fault reading leaves out.  With
``--forward 1`` the clustered build keeps every forward edge first (the
exact build's rule) in place of ``clustered_fkeep``: the graph that
``unreachable``'s limit is set against.  One JSON line a seed, then the
port's largest and each fault's smallest numbers over the seeds.  The
lower reading of a limit is the largest the port gives, the upper the
smallest a fault gives.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "benchmark"]

CELL = "marco-hnsw128-b48"


def readings(seed: int, *, workload: str = CELL, forward: bool = False,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """The port's, the fault's and the control's numbers for one seed."""
    import torch

    from benchmark import compare, harness
    from duckdb_faiss_ext_tpu_torch.ops import graph as graph_ops

    _, cfg, traffic, _, _ = harness.load_spec(workload)
    cfg = {**cfg, **(overrides or {})}
    dev = torch.device(device)
    rule = graph_ops.clustered_fkeep
    if forward:
        graph_ops.clustered_fkeep = lambda degree: degree
    try:
        t0 = time.perf_counter()
        data, pool, system = harness.build(cfg, traffic, seed, dev)
        answers = [system.search(b) for b in pool]     # builds the graph
        faulty = [system.fault_search(b) for b in pool]
        harness.sync(dev)
        t_build = time.perf_counter() - t0
    finally:
        graph_ops.clustered_fkeep = rule
    state = harness.free(system, dev)
    del system
    ref = harness.part("reference", cfg["family"])
    P, B = pool.shape[:2]
    limits = cfg["limits"]
    out = {"seed": seed, "forward": forward, "build_s": t_build}
    t0 = time.perf_counter()
    for side, got, control in (("program", answers, True),
                               ("fault_search", faulty, False)):
        numbers, failed, _, sol = harness.check_answers(
            cfg, traffic, pool.reshape(P * B, -1), got,
            [(0.0, 0.0, b) for b in range(P)],
            lambda q, wq, wl: ref.solve(cfg, data, q, state, wq, wl,
                                        control=control), limits)
        numbers.update({n: v for n, (v, _) in sol.checks.items()})
        out[side] = dict(numbers, failed=failed)
        if control:
            cnum, cfail = compare.compare_control(
                sol, cfg["metric"] == "INNER_PRODUCT", limits)
            out["control"] = dict(cnum, failed=int(cfail.sum()))
            out["detail"] = {n: v for n, v in (sol.detail or {}).items()
                             if isinstance(v, (int, float))}
    for side in ("program", "fault_search", "control"):
        out[side]["over_limit"] = sorted(
            n for n, lim in limits.items() if out[side].get(n, 0) > lim)
    out["reference_s"] = time.perf_counter() - t0
    del data, sol, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--forward", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(seed, workload=args.workload,
                             forward=bool(args.forward)))
        print(json.dumps(rows[-1]), flush=True)
    for side in ("program", "fault_search", "control"):
        agg = max if side == "program" else min
        names = [n for n, v in rows[0][side].items()
                 if isinstance(v, (int, float))]
        print(json.dumps({side: {n: agg(r[side][n] for r in rows)
                                 for n in names}, "over": agg.__name__}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
