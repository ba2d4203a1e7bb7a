"""roofline_pct.qps: benchmark.readers.roofline_pct, the reading that moves
qps, in the cells whose end-to-end guard is qps (the IVF cells)."""

from benchmark.readers import roofline_pct as read  # noqa: F401
