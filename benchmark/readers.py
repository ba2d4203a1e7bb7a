"""What the per-layer metric readers (``metrics/<name>.py``) share.

Each takes the finished run and returns a number, or None where the run
has nothing to read (no trace, or no device operation in it).
"""

from __future__ import annotations

import numpy as np


def p95_ms(run):
    """The 95th percentile of the window's calls, ms on the host clock."""
    if not run.calls:
        return None
    return float(np.percentile([1e3 * (c[1] - c[0]) for c in run.calls], 95))


def _trace(run):
    tr = getattr(run, "trace", None)
    return tr if tr is not None and tr.dev_start.size else None


def device_idle_pct(run):
    """% of the traced slice in which no kernel, copy or fill runs."""
    tr = _trace(run)
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(run):
    """% : the least time the card could take for the slice's calls
    (``work/<family>.py``) over the device's busy time in the slice."""
    tr = _trace(run)
    if tr is None or tr.busy_s <= 0 or not run.slice_bound_s:
        return None
    return 100.0 * run.slice_bound_s / tr.busy_s


def torch_device_ms(run):
    """ms a call of device operations that are not the port's own kernels
    (the torch glue and the copies)."""
    tr = _trace(run)
    if tr is None:
        return None
    other = ~tr.dev_own
    return 1e3 * float((tr.dev_end[other] - tr.dev_start[other]).sum()) \
        / tr.calls


def launches_per_call(run):
    """Device operations (kernels, copies, fills) a call."""
    tr = _trace(run)
    if tr is None:
        return None
    return tr.dev_start.size / tr.calls
