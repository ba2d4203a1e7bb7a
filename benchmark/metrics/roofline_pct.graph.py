"""roofline_pct.graph: benchmark.readers.roofline_pct, the least time the
card could take for the slice's walks (work/hnsw.py: efSearch expansions a
query, each reading its degree candidate rows once) over the device's busy
time; the reading that moves qps, in the HNSW cell."""

from benchmark.readers import roofline_pct as read  # noqa: F401
