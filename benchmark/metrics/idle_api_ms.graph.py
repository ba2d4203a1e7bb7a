"""idle_api_ms.graph: benchmark.spans.idle_api_ms, ms a call of the traced
slice's device-idle time during which the innermost span open on the host
was one of the API layer's spans (api.*: the root api.faiss_search,
api.args, api.upload, api.fetch, api.format); the reading that moves qps,
in the HNSW cell."""

from benchmark.spans import idle_api_ms as read  # noqa: F401
