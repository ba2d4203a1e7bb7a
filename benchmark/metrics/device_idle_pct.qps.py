"""device_idle_pct.qps: benchmark.readers.device_idle_pct, the reading that
moves qps, in the cells whose end-to-end guard is qps (the IVF cells)."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
