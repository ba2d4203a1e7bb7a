"""Three-strategy filtered-search benchmark.

Port of the reference's Go benchmark core (go/main_test.go:18-51,
go/benches_c.go:124-201): for each filter passrate, compare

* **post**: plain search with an enlarged k' followed by filtering the
  results (the reference's SQL JOIN + WHERE);
* **sel**:  faiss_search_filter — dense-bitmap selector, O(n);
* **set**:  faiss_search_filter_set — id-set selector, O(m).

The enlarged k' is the smallest k such that P[Binomial(k, passrate) ≥ want]
≥ 0.99, found by bisection exactly like go/main_test.go:104-128.

A copy of ``duckdb_faiss_ext_tpu/harness/filtered.py`` but for the CPU
baseline: ``run_filtered_bench`` extrapolates it to the searched index's
rows and scans with the index's metric, where the JAX package scaled it by
the query count and took the metric from its caller.
"""

from __future__ import annotations

import dataclasses
import time
from math import lgamma, exp

import numpy as np

from .. import api
from ..catalog import Catalog
from ..sql.engine import Database


def _binom_pmf(k: int, n: int, p: float) -> float:
    if p <= 0.0:
        return 1.0 if k == 0 else 0.0
    if p >= 1.0:
        return 1.0 if k == n else 0.0
    logc = lgamma(n + 1) - lgamma(k + 1) - lgamma(n - k + 1)
    return exp(logc + k * np.log(p) + (n - k) * np.log1p(-p))


def prob_at_least(want: int, n: int, p: float) -> float:
    """P[Binomial(n, p) >= want]."""
    return 1.0 - sum(_binom_pmf(i, n, p) for i in range(min(want, n + 1)))


def required_k(want: int, passrate: float, confidence: float = 0.99,
               upper: int = 1 << 20) -> int:
    """Smallest k with P[Binomial(k, passrate) ≥ want] ≥ confidence
    (bisection, go/main_test.go:104-128)."""
    lo, hi = want, upper
    while lo < hi:
        mid = (lo + hi) // 2
        if prob_at_least(want, mid, passrate) >= confidence:
            hi = mid
        else:
            lo = mid + 1
    return lo


@dataclasses.dataclass
class FilteredBenchResult:
    passrate: float
    required_k: int
    qps_post: float
    qps_sel: float
    qps_set: float
    #: scaled CPU brute-force stand-in for the reference's VSS / plain-SQL
    #: comparison columns (go/main_test.go:53-102); None when not measured
    qps_cpu: float | None = None


def cpu_filtered_baseline(d: int, n_total: int, queries: np.ndarray,
                          want: int, passrate: float,
                          metric: str = "INNER_PRODUCT",
                          sample: int = 65_536, iters: int = 3,
                          seed: int = 13) -> float:
    """CPU filtered-search baseline, the reference's VSS/plain-SQL column
    analogue (go/main_test.go:53-102): numpy BLAS exact scan over a
    corpus sample with the ``id % 100`` predicate masked in, partial
    top-``want`` select, timed and scaled linearly to ``n_total`` rows —
    the same subsample-and-scale methodology as bench.py's
    measure_cpu_baseline.  The sample is synthetic (same family as the
    serving corpus); a scan's cost depends on shape, not values."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((sample, d), dtype=np.float32)
    if metric == "INNER_PRODUCT":
        xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    thresh = max(1, int(round(passrate * 100)))
    passing = (np.arange(sample) % 100) < thresh
    xq = np.ascontiguousarray(queries, dtype=np.float32)
    xb_norms = (xb * xb).sum(axis=1)

    def run():
        if metric == "INNER_PRODUCT":
            s = xq @ xb.T
            s[:, ~passing] = -np.inf
            idx = np.argpartition(-s, want, axis=1)[:, :want]
            part = np.take_along_axis(-s, idx, axis=1)
        else:
            s = xb_norms[None, :] - 2.0 * (xq @ xb.T)
            s[:, ~passing] = np.inf
            idx = np.argpartition(s, want, axis=1)[:, :want]
            part = np.take_along_axis(s, idx, axis=1)
        order = np.argsort(part, axis=1)
        return np.take_along_axis(idx, order, axis=1)

    run()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    per_batch = best * (n_total / sample)
    return queries.shape[0] / per_batch


def run_filtered_bench(
    index_name: str,
    queries: np.ndarray,
    table: str,
    id_column: str,
    passrates=(0.01, 0.10, 0.50, 0.99),
    want: int = 10,
    catalog: Catalog | None = None,
    database: Database | None = None,
    params=None,
    iters: int = 3,
    cpu_baseline: bool = False,
) -> list[FilteredBenchResult]:
    """Benchmark the three strategies.  The filter predicate is
    ``id % 100 < passrate*100`` over the registered table — the reference's
    ``sel=i%100`` scheme (go/benches_c.go:31).  With ``cpu_baseline`` the
    CPU column scans with the index's metric and is extrapolated to its
    rows."""
    from ..sql.engine import default_database

    db = database if database is not None else default_database()
    nq = queries.shape[0]
    index = api._cat(catalog).get(index_name).index
    out = []
    for p in passrates:
        kp = required_k(want, p)
        thresh = max(1, int(round(p * 100)))
        filt = f"{id_column}%100<{thresh}"

        def post():
            res = api.faiss_search(index_name, kp, queries, params, catalog)
            keep = (res["label"] % 100) < thresh
            return res, keep

        def sel():
            return api.faiss_search_filter(index_name, want, queries, filt,
                                           id_column, table, params, catalog,
                                           database=db)

        def sset():
            return api.faiss_search_filter_set(index_name, want, queries,
                                               filt, id_column, table,
                                               params, catalog, database=db)

        def timeit(fn):
            fn()  # warmup/compile
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return nq * iters / (time.perf_counter() - t0)

        qps_cpu = None
        if cpu_baseline:
            qps_cpu = cpu_filtered_baseline(
                queries.shape[1], index.ntotal, queries, want, p,
                metric=index.metric.name, iters=iters)
        out.append(FilteredBenchResult(
            passrate=p, required_k=kp,
            qps_post=timeit(post), qps_sel=timeit(sel),
            qps_set=timeit(sset), qps_cpu=qps_cpu))
    return out
