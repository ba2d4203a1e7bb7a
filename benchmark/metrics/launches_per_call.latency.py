"""launches_per_call.latency: benchmark.readers.launches_per_call, the
reading that moves latency_p95_ms, in the cells that report it (the Flat
cells)."""

from benchmark.readers import launches_per_call as read  # noqa: F401
