"""Work of one filtered IVF,Flat search call: the least that any
implementation has to move and compute.

Bytes: the fp32 rows that pass the filter in the distinct lists the batch
probes, each read once; one bit a row of those lists for the filter; the
centroid table; the caller's query rows; the (distance, label) results.
Operations: the coarse scores (2·d a query and list) and 2·d a query and
passing row of its probed lists, on fp32 operands.  ``detail`` carries the
pool's exact probes (P, nprobe), ``list_rows`` (nlist,), the rows each
list holds, and ``list_pass`` (nlist,), those of them that pass.
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
    passing = np.asarray(detail["list_pass"], np.int64)
    lists = np.unique(probes)
    once = int(passing[lists].sum())
    bits = int(rows[lists].sum())
    scored = int(passing[probes].sum())
    nbytes = (4 * d * (once + nlist + nq) + -(-bits // 8)
              + RESULT_BYTES * nq * k)
    return nbytes, {"tf32": 2 * d * (nq * nlist + scored)}
