"""device_idle_pct.filter: benchmark.readers.device_idle_pct, the reading
that moves qps, in the filtered cell (marco-ivf2048-filter10-b48)."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
