"""roofline_pct.filter: benchmark.readers.roofline_pct, the least time the
card could take for the slice's filtered calls (work/ivf_filter.py: the
passing rows of the probed lists read once) over the device's busy time
(K6 over the unpadded layout and K1's coarse stage, most of it); the
reading that moves qps, in the filtered cell."""

from benchmark.readers import roofline_pct as read  # noqa: F401
