"""The traced slice of a ``--trace 1`` run, and what is read from it.

``torch.profiler`` (CPU and, on a card, CUDA activity) records a run of
consecutive calls in the steady part of the window, after a few warm-up
steps it discards; each call sits inside a ``bench.call`` annotation.  The
Chrome trace it writes is parsed here: the device operations (kernels,
copies, fills) with their times, the host operations between them, and
the slice's bounds (the first call's start to the last call's end).
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import torch

CALL = "bench.call"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}
#: steps profiled and discarded before the slice
WARMUP = 2
#: host activity named when no host operation covers an idle moment
NO_OP = "host python (no torch op)"
#: entries of each breakdown list
TOP = 10


class Slice:
    """The profiler over ``active`` calls after ``WARMUP`` discarded ones;
    the trace is written to ``path`` when the last active call is done."""

    def __init__(self, active: int, path: Path):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.path, self.active, self.steps = path, active, 0
        self.prof = profile(
            activities=acts,
            schedule=schedule(wait=0, warmup=WARMUP, active=active,
                              repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
        self.prof.start()

    @property
    def done(self) -> bool:
        return self.steps >= WARMUP + self.active

    def step(self) -> None:
        self.prof.step()
        self.steps += 1
        if self.done:
            self.prof.stop()


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    #: device operations: start, end (s, trace clock), the port's own
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_own: np.ndarray
    #: idle seconds by host activity, and device seconds by operation
    idle_by_host: dict
    device_by_op: dict


def own_kernel_names(root: Path) -> set:
    """The ``__global__`` functions declared in the port's CUDA sources."""
    names = set()
    for src in sorted((root / "duckdb_faiss_ext_tpu_torch" / "csrc").glob(
            "*.cu*")):
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
        for m in re.finditer(r"__global__", text):
            for f in re.finditer(r"([A-Za-z_]\w*)\s*\(", text[m.end():]):
                if f.group(1) != "__launch_bounds__":
                    names.add(f.group(1))
                    break
    return names


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    s = "".join(out).strip()
    return s if len(s) <= 96 else s[:93] + "..."


def _union(starts: np.ndarray, ends: np.ndarray):
    """Disjoint sorted intervals covering the given ones."""
    if starts.size == 0:
        return np.empty(0), np.empty(0)
    order = np.argsort(starts)
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def _host_at(points, h_start, h_end, h_name, max_dur):
    """The innermost host operation covering each time point, or NO_OP."""
    names = []
    for t in points:
        lo = np.searchsorted(h_start, t - max_dur)
        hi = np.searchsorted(h_start, t, side="right")
        cover = np.nonzero(h_end[lo:hi] >= t)[0]
        if cover.size == 0:
            names.append(NO_OP)
            continue
        dur = h_end[lo:hi][cover] - h_start[lo:hi][cover]
        names.append(h_name[lo + cover[np.argmin(dur)]])
    return names


def parse(path: Path, own: set) -> Trace | None:
    """The slice's device and host activity; None without a trace."""
    if not path.exists():
        return None
    events = json.loads(path.read_text()).get("traceEvents", [])
    calls, dev, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        span = (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"]))
                * 1e-6, str(e.get("name", "")))
        if cat == "user_annotation" and span[2] == CALL:
            calls.append(span)
        elif cat in DEVICE_CATS:
            dev.append(span)
        elif cat in HOST_CATS:
            host.append(span)
    if not calls:
        return None
    w0 = min(c[0] for c in calls)
    w1 = max(c[1] for c in calls)
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    d_s = np.array([max(d[0], w0) for d in dev])
    d_e = np.array([min(d[1], w1) for d in dev])
    d_n = [d[2] for d in dev]
    pats = [re.compile(rf"(?<![\w]){re.escape(n)}(?![\w])") for n in own]
    d_own = np.array([any(p.search(n) for p in pats) for n in d_n], bool)
    u_s, u_e = _union(d_s, d_e)
    busy = float((u_e - u_s).sum())
    by_op: dict = {}
    for n, s, e in zip(d_n, d_s, d_e):
        key = short_name(n)
        by_op[key] = by_op.get(key, 0.0) + float(e - s)
    # idle gaps: the window minus the device's busy intervals, each
    # sampled at a few points and charged to the host operation there
    g_s = np.concatenate([[w0], u_e])
    g_e = np.concatenate([u_s, [w1]])
    keep = g_e > g_s
    g_s, g_e = g_s[keep], g_e[keep]
    host.sort()
    h_s = np.array([h[0] for h in host])
    h_e = np.array([h[1] for h in host])
    h_n = [h[2] for h in host]
    max_dur = float((h_e - h_s).max()) if host else 0.0
    idle: dict = {}
    for s, e in zip(g_s, g_e):
        m = int(min(8, max(1, (e - s) / 25e-6)))
        pts = s + (np.arange(m) + 0.5) * (e - s) / m
        for n in _host_at(pts, h_s, h_e, h_n, max_dur):
            idle[n] = idle.get(n, 0.0) + float(e - s) / m
    return Trace(window_s=float(w1 - w0), busy_s=busy, calls=len(calls),
                 dev_start=d_s, dev_end=d_e, dev_own=d_own,
                 idle_by_host=idle, device_by_op=by_op)


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time and the host activity
    during the longest idle time, in seconds over the slice."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP]
    return {"device_ops": top(tr.device_by_op),
            "idle_gaps": top(tr.idle_by_host)}
