"""The readings that the limits of the comparison are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--control 1]

For each seed, in one process: the cell's set-up, one call of every pool
batch through the port (as the window sends them), the index freed, then
the plain reference; the port's answers are judged, and with ``--control
1`` also the control's: the reference itself put in the port's place,
its products in TF32, the precision below the fp32 the configurations
state.  Where the system has a fault to read (``fault_search``: an IVF
search one probe short) and the reference one (``untrained_gain``: the
k-means check of an untrained table), those too.  One JSON line a seed.  The
lower reading of a limit is the largest the port gives over many seeds,
the upper the smallest the control gives.  Not part of a benchmark run.
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


def readings(workload: str, seed: int, control: bool, *,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """The port's numbers (and the control's) for one seed."""
    import numpy as np
    import torch

    from benchmark import compare, harness

    cell, cfg, traffic, _, _ = harness.load_spec(workload)
    cfg = {**cfg, **(overrides or {})}
    dev = torch.device(device)
    t0 = time.perf_counter()
    data, pool, system = harness.build(cfg, traffic, seed, dev)
    answers = [system.search(pool[b]) for b in range(len(pool))]
    faulty = ([system.fault_search(pool[b]) for b in range(len(pool))]
              if hasattr(system, "fault_search") else None)
    calls = [(0.0, 0.0, b) for b in range(len(pool))]
    harness.sync(dev)
    t_build = time.perf_counter() - t0
    state = harness.free(system, dev)
    del system
    ref = harness.part("reference", cfg["family"])
    P, B = pool.shape[:2]
    limits = cfg["limits"]
    t0 = time.perf_counter()
    out = {}
    numbers, failed, _, sol = harness.check_answers(
        cfg, traffic, pool.reshape(P * B, -1), answers, calls,
        lambda q, wq, wl: ref.solve(cfg, data, q, state, wq, wl,
                                    control=control), limits)
    numbers.update({n: v for n, (v, _) in sol.checks.items()})
    out["program"] = dict(numbers, failed=failed)
    if faulty is not None:
        fnum, ffail, _, _ = harness.check_answers(
            cfg, traffic, pool.reshape(P * B, -1), faulty, calls,
            lambda q, wq, wl: ref.solve(cfg, data, q, state, wq, wl),
            limits)
        out["fault_search"] = dict(fnum, failed=ffail)
    if hasattr(ref, "untrained_gain"):
        out["fault_untrained_gain"] = ref.untrained_gain(cfg, data, seed)
    if control:
        sim = cfg["metric"] == "INNER_PRODUCT"
        cnum, cfail = compare.compare_control(sol, sim, limits)
        out["control"] = dict(cnum, failed=int(cfail.sum()))
        out["control_recall"] = (None if sol.truth is None else float(np.mean(
            [len(set(a) & set(b)) / a.shape[0]
             for a, b in zip(sol.control["labels"], sol.truth)])))
    out.update(seed=seed, build_s=t_build,
               reference_s=time.perf_counter() - t0,
               detail={n: v for n, v in (sol.detail or {}).items()
                       if isinstance(v, (int, float))})
    del data, sol, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(args.workload, seed, bool(args.control)))
        print(json.dumps(rows[-1]), flush=True)
    for side in ("program", "control", "fault_search"):
        if side in rows[0]:
            agg = max if side == "program" else min
            print(json.dumps({side: {n: agg(r[side][n] for r in rows)
                                     for n in rows[0][side]},
                              "over": agg.__name__}), flush=True)
    if "fault_untrained_gain" in rows[0]:
        print(json.dumps({"fault_untrained_gain": min(
            r["fault_untrained_gain"] for r in rows), "over": "min"}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
