"""Tracing, timing and engine statistics.

* ``span(name)`` — a named range of the port's own work.  While a
  ``torch.profiler`` records (``trace(path)`` below, or any other), it
  opens a profiler range, which the trace holds as a ``user_annotation``
  on the clock of the card's kernels and copies; nesting gives parent and
  child.  While none records it costs one flag check and records nothing.
  Names are ``<layer>.<what>`` with the layers ``api`` (``api.py``,
  ``utils/transfer.py``), ``models`` (``models/``) and ``kernels`` (the
  wrappers of the hand-written kernels in ``ops/`` and their library).
  ``spanned(name)`` puts a span around a whole function;
* ``build_span(name)`` — the span of a cache that builds (``name`` ends in
  ``_build`` or ``_upload``), counted in ``counters()`` as ``name + "s"``;
* ``count(name)`` — one more of an event in ``counters()``;
* ``trace(path)`` — context manager around ``torch.profiler`` writing a
  Chrome trace (chrome://tracing, Perfetto) of everything inside: the
  host's torch operators, the port's spans and, on a CUDA device, the
  card's kernels;
* ``timed(op)`` — the wall time of each public operation accumulated in
  a process-global registry (counts and latencies), and its root span
  ``api.<op>``;
* ``stats()`` / ``counters()`` / ``reset_stats()`` — snapshot / clear,
  exposed through ``faiss_stats`` (``"ops"``, ``"counters"``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict

import torch

#: whether a torch.profiler records now (one C call)
_recording = torch.autograd._profiler_enabled

#: open / close a profiler range in the user scope
_enter = torch._C._autograd._record_function_with_args_enter
_exit = torch._C._autograd._record_function_with_args_exit


class _Range:
    """An open profiler range in the user scope: the trace holds it as a
    ``user_annotation`` event, the category of ``record_function``, at a
    fraction of its cost.  (``_RecordFunctionFast`` is cheaper still, but
    its ranges are ``cpu_op`` events, which a reader of the trace takes
    for torch operators.)"""

    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name
        self.handle = None

    def __enter__(self):
        self.handle = _enter(self.name)

    def __exit__(self, *exc):
        _exit(self.handle)


class _NoRange:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_NO_RANGE = _NoRange()


def span(name: str):
    """Context manager: the range ``name`` under a recording profiler,
    else nothing."""
    return _Range(name) if _recording() else _NO_RANGE


def spanned(name: str):
    """Decorator: the function's every call inside ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


class _OpStats:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    def as_dict(self):
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_ms": round(1e3 * self.total_s / self.count, 3)
            if self.count else 0.0,
            "max_ms": round(1e3 * self.max_s, 3),
        }


_lock = threading.Lock()
_stats: dict[str, _OpStats] = defaultdict(_OpStats)
#: cache builds by kind (``build_span``) and events (``count``)
_counters: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def timed(op: str):
    t0 = time.perf_counter()
    rng = _Range("api." + op) if _recording() else None
    if rng is not None:
        rng.__enter__()
    try:
        yield
    finally:
        if rng is not None:
            rng.__exit__(None, None, None)
        dt = time.perf_counter() - t0
        with _lock:
            _stats[op].add(dt)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; ``count(name, 0)`` makes it
    present at 0."""
    with _lock:
        _counters[name] += n


def build_span(name: str):
    """``span(name)`` around a cache's build, counted as ``name + "s"``."""
    count(name + "s")
    return span(name)


def stats() -> dict:
    with _lock:
        return {k: v.as_dict() for k, v in sorted(_stats.items())}


def counters() -> dict:
    """Cache builds and events since the process started (or
    ``reset_stats``): ``kernels.library_builds`` (the kernel library
    loaded, and compiled where no build of its sources was on disk),
    ``models.layout_builds`` (an IVF index's device layout),
    ``models.rows_uploads`` (a Flat index's corpus buffer) and
    ``models.mask_builds`` (a selector's mask on the device), each present
    once it has happened; ``models.coarse_kernel`` (IVF coarse stages that
    K1 served, ops/ivf_scan.py), present from import."""
    with _lock:
        return dict(sorted(_counters.items()))


def reset_stats() -> None:
    """Clear the operation statistics and zero every counter."""
    with _lock:
        _stats.clear()
        _counters.update(dict.fromkeys(_counters, 0))


@contextlib.contextmanager
def trace(path: str):
    """Profile the enclosed block with ``torch.profiler`` (the CPU and,
    where a card is present, the CUDA activity) and write a Chrome trace
    to ``path``; its directory is made if missing."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
