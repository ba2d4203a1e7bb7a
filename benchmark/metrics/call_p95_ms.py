"""call_p95_ms: the 95th percentile of every call of the window on the host
clock, read as ``latency_p95_ms`` is, in the cells where that tail swings
with the host too widely between runs to carry a bound (the IVF cells);
there it moves qps.  In a traced run the profiled slice lies inside it."""

from benchmark.readers import p95_ms as read  # noqa: F401
