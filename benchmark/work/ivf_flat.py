"""Work of one IVF,Flat search call (chip_smoke.py::probed_rows).

Bytes: the fp32 rows of the distinct lists the batch probes, read once;
the centroid table; the caller's query rows; the (distance, label)
results.  Operations: the coarse scores (2·d a query and list) and the
scan (2·d a query and probed row), on fp32 operands.  ``detail`` carries
the pool's probes (P, nprobe), the exact top-nprobe lists of each query,
and ``list_rows`` (nlist,), the rows each list holds.
"""

from __future__ import annotations

import numpy as np

from . import RESULT_BYTES


def call_work(cfg: dict, queries: slice, detail: dict):
    """(bytes, {operand type: operations}) of one call over the pool's
    query rows ``queries``."""
    d, k, nlist = int(cfg["d"]), int(cfg["k"]), int(cfg["nlist"])
    probes = np.asarray(detail["probes"])[queries]
    nq = probes.shape[0]
    rows = np.asarray(detail["list_rows"], np.int64)
    once = int(rows[np.unique(probes)].sum())
    scored = int(rows[probes].sum())
    nbytes = 4 * d * (once + nlist + nq) + RESULT_BYTES * nq * k
    return nbytes, {"tf32": 2 * d * (nq * nlist + scored)}
