"""torch_device_ms.graph: benchmark.readers.torch_device_ms, ms a call of
device operations that are not the port's own kernels, in the HNSW cell,
where they are nearly all of the device's work: the walk's gathers,
products and sorts in plain torch; the reading that moves qps."""

from benchmark.readers import torch_device_ms as read  # noqa: F401
