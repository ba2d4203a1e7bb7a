"""torch_device_ms.qps: benchmark.readers.torch_device_ms, the reading that
moves qps, in the cells whose end-to-end guard is qps (the IVF cells)."""

from benchmark.readers import torch_device_ms as read  # noqa: F401
