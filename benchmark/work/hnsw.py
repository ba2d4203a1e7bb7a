"""Work of one HNSW search call, from the configuration alone: the
best-first walk's expansion budget on layer 0 (FAISS's ``efSearch``).

A walk that ends with ``efSearch`` entries in its pool has expanded about
``efSearch`` nodes a query, and scored each one's ``degree`` neighbours.
Bytes: those nq × efSearch × degree candidate rows of 4·d bytes, the
expanded nodes' adjacency rows of 4·degree bytes, the caller's query
rows, the (distance, label) results.  Operations: 2·d a candidate on fp32
operands.  A walk that expands more, or reads a row twice, does more than
this, never less.
"""

from __future__ import annotations

from . import RESULT_BYTES


def call_work(cfg: dict, queries: slice, detail: dict | None = None):
    """(bytes, {operand type: operations}) of one call over the pool's
    query rows ``queries``."""
    nq = queries.stop - queries.start
    d, k = int(cfg["d"]), int(cfg["k"])
    ef, deg = int(cfg["ef_search"]), int(cfg["graph_degree"])
    expanded = nq * ef
    cand = expanded * deg
    nbytes = (4 * d * cand + 4 * deg * expanded + 4 * d * nq
              + RESULT_BYTES * nq * k)
    return nbytes, {"tf32": 2 * d * cand}
