"""Recall measurement against ground truth (BASELINE.json north-star:
recall@10 reported alongside QPS).

A copy of ``duckdb_faiss_ext_tpu/harness/recall.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(got_labels: np.ndarray, gt_labels: np.ndarray,
                k: int | None = None) -> float:
    """Mean |got ∩ gt| / k over queries.  got/gt: (nq, ≥k) label arrays."""
    if k is None:
        k = got_labels.shape[1]
    nq = got_labels.shape[0]
    hits = 0
    for q in range(nq):
        hits += len(set(got_labels[q, :k].tolist())
                    & set(gt_labels[q, :k].tolist()))
    return hits / (nq * k)
