"""idle_models_ms.graph: benchmark.spans.idle_models_ms, ms a call of the
traced slice's device-idle time during which the innermost span open on the
host was one of the models layer's spans (models.*: dispatch, labels and
models.graph_walk, the walk around ops/graph.py's graph_search); the
reading that moves qps, in the HNSW cell."""

from benchmark.spans import idle_models_ms as read  # noqa: F401
