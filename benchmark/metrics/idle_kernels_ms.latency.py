"""idle_kernels_ms.latency: benchmark.spans.idle_kernels_ms, ms a call of the traced
slice's device-idle time during which the innermost span open on the host
was one of the kernels layer's spans (kernels.*: each own kernel's wrapper, from its plan and allocations to the return after its launches, and the library's build); the reading that moves latency_p95_ms, in the Flat cells."""

from benchmark.spans import idle_kernels_ms as read  # noqa: F401
