"""The port's spans in the traced slice, and the device's idle time charged
to them.

The port opens a span (``utils/profiling.py::span``) at each boundary of a
call's layers, named ``<layer>.<what>``: ``api`` (arguments, upload,
fetch, formatting), ``models`` (dispatch, coarse probes, routing, labels,
cache builds) and ``kernels`` (the wrappers of its own kernels).  The
profiler keeps each as a ``user_annotation`` event of the slice's Chrome
trace, on the clock of the card's operations.  Every instant of the slice
at which the device is idle (the window minus the union of its
operations, as ``trace.parse`` builds them from ``run.trace``) is charged,
by exact interval intersection, to the innermost port span open on the
host then, or to ``caller`` outside every one (the harness's loop and the
profiler's steps).  Sums by layer, in ms a call, are the metrics
``idle_<layer>_ms.*``.

The harness hands a reader only ``run`` and removes the slice's trace
file before the readers run, but the slice's profiler still holds its
events (Kineto saves a trace once).  The profiler is found among the
locals of the harness frame that calls the reader, and its events are
written again as Kineto writes them (``rewrite``: each event's category,
told from its device and kind, its name, start and length, in µs to the
ns from Kineto's base time).  That trace is parsed by ``trace.parse`` and
checked against ``run.trace`` (the calls, the window, the busy time,
every device operation) before anything is charged.  Where it differs,
or the slice holds no port span (a program without them), nothing is
read.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
from torch.autograd import DeviceType

from . import trace

ROOT = Path(__file__).resolve().parent.parent
#: span name prefixes of the port's layers, and where idle time outside
#: every port span goes
LAYERS = ("api", "models", "kernels")
CALLER = "caller"
#: the root span of a search call
ROOT_SPAN = "api.faiss_search"
#: Kineto writes a trace's times from the start of the current period of
#: this many seconds since the epoch (its ``ChromeTraceBaseTime``)
KINETO_PERIOD_S = 7889238

#: (run, result) of the last reading: the metrics of one run share it
_last: tuple = (None, None)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def layer_of(name: str) -> str | None:
    """The port layer a span's name starts with, or None for another
    annotation."""
    head = name.split(".", 1)[0]
    return head if head in LAYERS and "." in name else None


def events(path: Path):
    """The slice's calls ``[(start, end)]`` and the port's spans ``[(start,
    end, name)]``, in seconds on the trace's clock."""
    calls, spans = [], []
    for e in json.loads(Path(path).read_text()).get("traceEvents", []):
        if (e.get("ph") != "X" or "dur" not in e
                or str(e.get("cat", "")).lower() != "user_annotation"):
            continue
        s = float(e["ts"]) * 1e-6
        iv = (s, (float(e["ts"]) + float(e["dur"])) * 1e-6)
        name = str(e.get("name", ""))
        if name == trace.CALL:
            calls.append(iv)
        elif layer_of(name):
            spans.append(iv + (name,))
    return calls, spans


def idle_intervals(tr: trace.Trace, w0: float, w1: float):
    """The window [w0, w1] minus the union of the device's operations, as
    ``trace.parse`` builds it: (starts, ends)."""
    u_s, u_e = trace._union(tr.dev_start, tr.dev_end)
    g_s = np.concatenate([[w0], u_e])
    g_e = np.concatenate([u_s, [w1]])
    keep = g_e > g_s
    return g_s[keep], g_e[keep]


def owners(spans):
    """Disjoint segments [(start, end, name)] covering the spans' extent,
    each named after the innermost span open through it: the one that
    opened last (the shorter of two that opened together)."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    open_, segs, t = {}, [], None
    for when, is_start, i in marks:
        if open_ and t is not None and when > t:
            inner = max(open_, key=lambda j: (spans[j][0], -spans[j][1]))
            segs.append((t, when, spans[inner][2]))
        t = when
        if is_start:
            open_[i] = True
        else:
            open_.pop(i, None)
    return segs


def charge(g_s, g_e, spans) -> dict:
    """Seconds of the idle intervals (g_s, g_e) by the innermost span open
    through them, ``CALLER`` where none is."""
    out: dict = {}
    segs = owners(spans)
    j = 0
    for s, e in zip(g_s.tolist(), g_e.tolist()):
        covered = 0.0
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            a, b = max(s, segs[k][0]), min(e, segs[k][1])
            if b > a:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (b - a)
                covered += b - a
            k += 1
        out[CALLER] = out.get(CALLER, 0.0) + ((e - s) - covered)
    return out


def summarize(by_span: dict, calls: int, idle_s: float) -> dict:
    """ms a call by span and by layer, the total and the root span's
    self share of the idle time."""
    ms = {n: 1e3 * v / calls for n, v in by_span.items()}
    layers = {la: 0.0 for la in LAYERS + (CALLER,)}
    for n, v in ms.items():
        layers[layer_of(n) or CALLER] += v
    return {"calls": calls, "by_span": ms, "by_layer": layers,
            "idle_ms": 1e3 * idle_s / calls,
            "root_self_share": (by_span.get(ROOT_SPAN, 0.0) / idle_s
                                if idle_s > 0 else 0.0)}


def from_trace(path: Path, tr: trace.Trace) -> dict | None:
    """The reading of a slice's Chrome trace at ``path``, whose parse is
    ``tr``; None where it holds no port span."""
    calls, spans = events(path)
    if not calls or not spans or tr is None or tr.calls == 0:
        return None
    w0, w1 = min(c[0] for c in calls), max(c[1] for c in calls)
    g_s, g_e = idle_intervals(tr, w0, w1)
    return summarize(charge(g_s, g_e, spans), tr.calls,
                     float((g_e - g_s).sum()))


def _slice():
    """The traced slice's ``trace.Slice`` among the locals of the frames
    that called the reader, or None."""
    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, trace.Slice):
                return v
        f = f.f_back
    return None


def _same(a: trace.Trace, b: trace.Trace) -> bool:
    """The same calls, window and device operations (in any order)."""
    def ops(t):
        order = np.lexsort((t.dev_end, t.dev_start))
        return t.dev_start[order], t.dev_end[order]

    return (a.calls == b.calls and a.window_s == b.window_s
            and a.busy_s == b.busy_s
            and all(np.array_equal(x, y) for x, y in zip(ops(a), ops(b))))


def category(e) -> str:
    """The Chrome trace category of an event the profiler holds, as far as
    ``trace.parse`` tells them apart: a device operation (``kernel``), a
    host or device annotation, or a host operation (``cpu_op``)."""
    host = e.device_type() == DeviceType.CPU
    if e.is_user_annotation():
        return "user_annotation" if host else "gpu_user_annotation"
    return "cpu_op" if host else "kernel"


def rewrite(held, path: Path, base_ns: int) -> None:
    """Write the events a stopped ``torch.profiler.profile`` holds
    (``held``) to ``path`` as Kineto writes its Chrome trace: each a
    complete event of its ``category``, ``ts`` and ``dur`` in µs to the ns,
    ``ts`` counted from ``base_ns``."""
    def us(ns: int) -> str:
        return f"{ns // 1000}.{ns % 1000:03d}"

    rows = []
    for e in held:
        start = e.start_ns()
        if start < base_ns:
            continue
        rows.append('{"ph": "X", "cat": "%s", "name": %s, "ts": %s, "dur": %s}'
                    % (category(e), json.dumps(e.name()),
                       us(start - base_ns), us(max(e.duration_ns(), 0))))
    path.write_text('{"traceEvents": [\n' + ",\n".join(rows) + "\n]}\n")


def bases(now_s: float):
    """Kineto's base time: the start of the current period of
    ``KINETO_PERIOD_S`` seconds since the epoch, or of the one before
    where the slice was traced before a period's end."""
    cur = int(now_s) // KINETO_PERIOD_S * KINETO_PERIOD_S
    return [cur * 10 ** 9, (cur - KINETO_PERIOD_S) * 10 ** 9]


def _read(run) -> dict | None:
    tr = getattr(run, "trace", None)
    sl = _slice()
    if tr is None or sl is None:
        return None
    try:
        held = sl.prof.profiler.kineto_results.events()
        ours = any(e.is_user_annotation() and layer_of(e.name())
                   for e in held)
    except (AttributeError, RuntimeError) as e:
        log(f"spans: the slice's events cannot be read: {e!r}")
        return None
    if not ours:
        log("spans: the slice holds no span of the program")
        return None
    own = trace.own_kernel_names(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "spans.json"
        for base in bases(time.time()):
            rewrite(held, path, base)
            again = trace.parse(path, own)
            if again is not None and _same(again, tr):
                break
        else:
            log("spans: the slice's events differ from the harness's trace "
                "at every base time; nothing read")
            return None
        res = from_trace(path, tr)
    if res is None:
        log("spans: the slice holds no span of the program")
        return None
    by = sorted(res["by_span"].items(), key=lambda kv: -kv[1])
    log(f"spans: device idle ms a call over {res['calls']} calls: "
        + ", ".join(f"{n} {v:.6f}" for n, v in by)
        + "; by layer " + ", ".join(f"{n} {v:.6f}"
                                    for n, v in res["by_layer"].items())
        + f"; sum {sum(res['by_layer'].values()):.6f} of idle "
        f"{res['idle_ms']:.6f}; {ROOT_SPAN} self "
        f"{100 * res['root_self_share']:.2f}% of idle")
    return res


def read(run) -> dict | None:
    """The run's reading (once a run), or None without a trace or spans."""
    global _last
    if _last[0] is not run:
        _last = (run, _read(run))
    return _last[1]


def layer_ms(run, layer: str):
    res = read(run)
    return None if res is None else res["by_layer"][layer]


def idle_api_ms(run):
    """ms a call of device-idle time charged to ``api.*`` spans."""
    return layer_ms(run, "api")


def idle_models_ms(run):
    """ms a call of device-idle time charged to ``models.*`` spans."""
    return layer_ms(run, "models")


def idle_kernels_ms(run):
    """ms a call of device-idle time charged to ``kernels.*`` spans."""
    return layer_ms(run, "kernels")
