"""launches_per_call.qps: benchmark.readers.launches_per_call, the reading
that moves qps, in the cells whose end-to-end guard is qps (the IVF
cells)."""

from benchmark.readers import launches_per_call as read  # noqa: F401
