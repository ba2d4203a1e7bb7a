"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the metrics.

The window drives the port's public entry ``faiss_search(name, k,
queries, parameters)``: host fp32 queries in, the host (rank, label,
distance) array out, in a closed loop with one caller, the calls back to
back, each taking the next batch of a pool drawn from the seed (cycling
through it).  Set-up (imports, the kernel library, the data drawn from the
seed, the ingest, one call of every pool batch) ends before the window
opens.  After it closes, the device's memory peak is read, the program's
index is freed, and the plain reference checks every answer the window
returned.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
import types
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from . import compare
from . import trace as tracing
from .work import bound_s

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "duckdb_faiss_ext_tpu")
#: share of the window that passes before the traced slice starts
TRACE_AT = 0.25
#: seconds of calls the traced slice covers, and its bounds in calls
SLICE_S, SLICE_MIN, SLICE_MAX = 1.0, 8, 4000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_spec(workload: str):
    """The cell's entry, its configuration file, its traffic file and the
    end-to-end and per-layer metrics it reports, all by name."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json")
        .read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])

    return (cell, cfg, traffic, [m for m in spec["end_to_end"] if applies(m)],
            [m for m in spec["per_layer"] if applies(m)])


def part(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(system, pool: np.ndarray, seconds: float, trace: bool,
           trace_path: Path):
    """The closed loop: (calls [(t0, t1, batch)], answers, errors, the
    index of the first traced call and the traced slice)."""
    calls, answers, errors = [], [], []
    prof, first = None, None
    start = time.perf_counter()
    deadline = start + seconds
    j = 0
    while True:
        t0 = time.perf_counter()
        live = prof is not None and not prof.done
        if t0 >= deadline and not live:
            break
        if trace and prof is None and t0 - start >= TRACE_AT * seconds:
            per_call = (t0 - start) / max(j, 1)
            prof = tracing.Slice(int(min(SLICE_MAX, max(
                SLICE_MIN, math.ceil(SLICE_S / per_call)))), trace_path)
            first, live = j + tracing.WARMUP, True
            t0 = time.perf_counter()
        b = j % len(pool)
        try:
            with (torch.profiler.record_function(tracing.CALL) if live
                  else nullcontext()):
                res = system.search(pool[b])
        except Exception as e:  # a failed call is counted, not fatal
            res = None
            errors.append(f"call {j}: {e!r}")
        t1 = time.perf_counter()
        calls.append((t0, t1, b))
        answers.append(res)
        if live:
            prof.step()
        j += 1
    return calls, answers, errors, first, prof, deadline


def check_answers(cfg, traffic, pool_flat, answers, calls, sol_fn, limits):
    """Solve the reference for the window's answers and judge them:
    (numbers, failed queries, recall answers (P, k) or None, solution)."""
    B, k = int(traffic["batch"]), int(cfg["k"])
    # answers equal byte for byte to one batch are judged once, and their
    # failures counted as often as they came
    done: dict = {}
    for c, a in zip(calls, answers):
        if a is not None:
            key = (c[2], hashlib.sha1(a.tobytes()).digest())
            done.setdefault(key, [c[2], a, 0])[2] += 1
    done = list(done.values())
    if done:
        qi = np.concatenate([b * B + np.arange(B) for b, _, _ in done])
        res = np.concatenate([a for _, a, _ in done])
        ranks, labels = res["rank"], res["label"]
        dists = res["distance"]
        times = np.repeat([n for _, _, n in done], B)
    else:
        qi = np.empty(0, np.int64)
        ranks = labels = np.empty((0, k), np.int64)
        dists = np.empty((0, k), np.float32)
        times = np.empty(0, np.int64)
    pq, pl, inv = compare.want_pairs(qi, labels)
    sol = sol_fn(pool_flat, pq, pl)
    sim = cfg["metric"] == "INNER_PRODUCT"
    numbers, failed = compare.compare_answers(qi, ranks, labels, dists, sol,
                                              inv, sim, limits)
    failed = failed * times
    sent, first = np.unique(qi, return_index=True)
    truth = (sol.truth[sent] if sol.truth is not None and sent.size
             else None)
    return numbers, int(failed.sum()), (labels[first], truth), sol


def device_info(dev: torch.device, peak: int, chips: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, for the log."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def pin(cores) -> None:
    """Every thread of the process on the last ``cores`` cores it may use,
    the same cores in every run on a machine; nothing where ``cores`` is
    None."""
    if not cores:
        return
    keep = sorted(os.sched_getaffinity(0))[-int(cores):]
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), keep)
        except OSError:  # a thread that ended meanwhile
            pass


def build(cfg, traffic, seed, dev):
    """The data, the pool (P, B, d) and the system, built from the seed."""
    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise ValueError("the harness drives one closed-loop caller")
    # the caller's host threads for torch's CPU operators, as the
    # configuration states them
    torch.set_num_threads(int(cfg["host_threads"]))
    if dev.type == "cuda":
        pin(cfg.get("host_cores"))
    data = part("data", cfg["generator"]).Data(cfg, seed, dev)
    B, P = int(traffic["batch"]), int(traffic["pool_batches"])
    pool = data.queries(B * P).reshape(P, B, int(cfg["d"]))
    system = part("systems", cfg["family"]).System(cfg, data, dev)
    return data, pool, system


def free(system, dev) -> dict:
    """The state the reference takes from the index; the index freed."""
    state = system.state()
    system.close()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return state


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None):
    """Run the cell once.  Returns (result line dict, comparison lines)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic, e2e, layer = load_spec(workload)
    cfg = {**cfg, **(overrides or {})}
    dev = torch.device(device)
    if dev.type == "cuda":
        log(f"card: {card_line()}")
        torch.cuda.reset_peak_memory_stats(dev)
    data, pool, system = build(cfg, traffic, seed, dev)
    for b in range(len(pool)):
        system.search(pool[b])
    sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    with tempfile.TemporaryDirectory() as tmp:
        trace_path = Path(tmp) / "slice.json"
        calls, answers, errors, first, prof, deadline = window(
            system, pool, seconds, trace, trace_path)
        if prof is not None and not prof.done:
            prof.prof.stop()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        tr = (tracing.parse(trace_path, tracing.own_kernel_names(ROOT))
              if trace else None)
    for e in errors[:5]:
        log(f"failed {e}")
    state = free(system, dev)
    del system

    t_ref = time.perf_counter()
    ref = part("reference", cfg["family"])
    P, B = pool.shape[0], pool.shape[1]
    pool_flat = pool.reshape(P * B, -1)
    limits = cfg["limits"]
    numbers, n_failed, (got, truth), sol = check_answers(
        cfg, traffic, pool_flat, answers, calls,
        lambda q, wq, wl: ref.solve(cfg, data, q, state, wq, wl), limits)
    for name, (value, limit) in sol.checks.items():
        numbers[name] = value
        limits = {**limits, name: limit}
    log(f"reference {time.perf_counter() - t_ref:.3f} s"
        + "".join(f"; {n} {v!r}" for n, v in (sol.detail or {}).items()
                  if isinstance(v, (int, float))))
    attempted = B * len(calls)
    failed = n_failed + B * len(errors)
    correct = (failed == 0 and not errors
               and all(numbers[n] <= limits[n] for n in numbers))

    in_window = [c for c in calls if c[1] <= deadline]
    work = part("work", cfg["family"])
    bound = [bound_s(*work.call_work(cfg, slice(b * B, (b + 1) * B),
                                     sol.detail))[0] for b in range(P)]
    run = types.SimpleNamespace(
        seconds=seconds, setup_s=setup_s, calls=in_window, batch=B,
        recall=(None if truth is None else
                part("data", "recall").recall_at_k(got, truth, int(cfg["k"]))),
        trace=tr,
        slice_bound_s=(sum(bound[c[2]] for c in
                           calls[first:first + tr.calls])
                       if tr is not None else 0.0))
    metrics = {}
    for m in (layer if trace else e2e):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    info = device_info(dev, peak, int(cell["chips"]))
    if trace and tr is not None:
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": info}
    if trace and tr is not None:
        result["breakdown"] = tracing.breakdown(tr)
    result["compared"] = {n: {"value": numbers[n], "limit": limits[n]}
                          for n in numbers}
    lines = [f"compared {n} {numbers[n]!r} limit {limits[n]!r}"
             for n in numbers]
    if in_window:
        lat = sorted(1e3 * (c[1] - c[0]) for c in in_window)
        log(f"window {len(calls)} calls ({len(in_window)} inside), "
            f"median {statistics.median(lat):.4f} ms")
    return result, lines
