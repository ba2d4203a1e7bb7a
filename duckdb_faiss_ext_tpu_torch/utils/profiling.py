"""Tracing, timing and engine statistics.

* ``trace(path)`` — context manager around ``torch.profiler`` writing a
  Chrome trace (chrome://tracing, Perfetto) of everything inside: the
  host's torch operators and, on a CUDA device, the card's kernels;
* ``timed(op)`` — lightweight per-op wall-clock accumulation into the
  process-global ``STATS`` registry (search/add/train counts and latencies);
* ``stats()`` / ``reset_stats()`` — snapshot/clear, exposed through
  ``faiss_stats``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch


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


@contextlib.contextmanager
def timed(op: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _stats[op].add(dt)


def stats() -> dict:
    with _lock:
        return {k: v.as_dict() for k, v in sorted(_stats.items())}


def reset_stats() -> None:
    with _lock:
        _stats.clear()


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
