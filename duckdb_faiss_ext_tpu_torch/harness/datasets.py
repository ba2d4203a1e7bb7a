"""Dataset loaders for benchmark/conformance runs.

* fvecs/ivecs/bvecs — the SIFT1M / Deep family on-disk formats (each vector
  prefixed by a little-endian int32 dimension), read from local files
  only.
* synthetic — seeded clustered corpora matching the benchmark shapes
  (SIFT1M-like 1M×128) so perf runs are self-contained, the analogue of the
  reference's random-data README workload (README.md:55-71).

A copy of ``duckdb_faiss_ext_tpu/harness/datasets.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def load_fvecs(path: str, max_rows: int | None = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.empty((0, 0), np.float32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].view(np.float32).copy()


def load_ivecs(path: str, max_rows: int | None = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].copy()


def load_bvecs(path: str, max_rows: int | None = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    d = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    stride = 4 + d
    rows = raw.reshape(-1, stride)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 4:].astype(np.float32)


def synthetic_dataset(n: int = 1_000_000, d: int = 128, nq: int = 1000,
                      ncl: int = 1024, seed: int = 42):
    """Clustered synthetic corpus + queries (queries drawn near corpus
    clusters so ANN recall is meaningful).  Returns (xb, xq, gt_ids) with
    gt_ids = None (compute with a flat search when needed)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 4.0
    xb = (centers[rng.integers(0, ncl, n)]
          + rng.standard_normal((n, d)).astype(np.float32))
    xq = (centers[rng.integers(0, ncl, nq)]
          + rng.standard_normal((nq, d)).astype(np.float32))
    return xb, xq
