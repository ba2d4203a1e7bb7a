"""device_idle_pct.graph: benchmark.readers.device_idle_pct, the reading
that moves qps, in the HNSW cell (marco-hnsw128-b48), where the graph walk
is most of a call."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
