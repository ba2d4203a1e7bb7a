"""latency_p95_ms: the 95th percentile of every call of the window, each
timed on the host clock from the call of ``faiss_search`` to its return
with host results."""

from benchmark.readers import p95_ms as read  # noqa: F401
