"""idle_models_ms.filter: benchmark.spans.idle_models_ms, ms a call of the
traced slice's device-idle time during which the innermost span open on the
host was one of the models layer's spans (models.*: dispatch, coarse, route,
labels and the cache builds models.layout_build, the unpadded layout's
per-list index, and models.mask_build, the selector's mask over it); the
reading that moves qps, in the filtered cell."""

from benchmark.spans import idle_models_ms as read  # noqa: F401
