"""Work of one exact Flat search call: every fp32 corpus row read once,
the caller's query rows read once, (distance, label) written once; 2·d
operations a (query, row) pair on fp32 operands (chip_smoke.py::k1_bounds)."""

from __future__ import annotations

from . import RESULT_BYTES


def call_work(cfg: dict, queries: slice, detail: dict | None = None):
    """(bytes, {operand type: operations}) of one call over the pool's
    query rows ``queries``."""
    nq = queries.stop - queries.start
    n, d, k = int(cfg["rows"]), int(cfg["d"]), int(cfg["k"])
    nbytes = 4 * n * d + 4 * nq * d + RESULT_BYTES * nq * k
    return nbytes, {"tf32": 2 * nq * n * d}
