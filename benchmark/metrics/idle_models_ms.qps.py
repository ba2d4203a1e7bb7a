"""idle_models_ms.qps: benchmark.spans.idle_models_ms, ms a call of the traced
slice's device-idle time during which the innermost span open on the host
was one of the models layer's spans (models.*: dispatch, coarse, route, labels and the cache builds); the reading that moves qps, in the IVF cells."""

from benchmark.spans import idle_models_ms as read  # noqa: F401
