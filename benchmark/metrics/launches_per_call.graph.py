"""launches_per_call.graph: benchmark.readers.launches_per_call, device
operations a call (the walk's gathers, scores and top-k a step), the
reading that moves qps, in the HNSW cell."""

from benchmark.readers import launches_per_call as read  # noqa: F401
