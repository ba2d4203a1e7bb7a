"""call_p95_ms.graph: the 95th percentile of every faiss_search call of the
window on the host clock, in the HNSW cell, where it moves qps.  In a
traced run the profiled slice lies inside it."""

from benchmark.readers import p95_ms as read  # noqa: F401
