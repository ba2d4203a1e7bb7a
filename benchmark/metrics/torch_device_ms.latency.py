"""torch_device_ms.latency: benchmark.readers.torch_device_ms, the reading
that moves latency_p95_ms, in the cells that report it (the Flat cells)."""

from benchmark.readers import torch_device_ms as read  # noqa: F401
