"""device_idle_pct.latency: benchmark.readers.device_idle_pct, the reading
that moves latency_p95_ms, in the cells that report it (the Flat cells)."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
