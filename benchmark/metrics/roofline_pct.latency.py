"""roofline_pct.latency: benchmark.readers.roofline_pct, the reading that
moves latency_p95_ms, in the cells that report it (the Flat cells)."""

from benchmark.readers import roofline_pct as read  # noqa: F401
