"""Benchmark & conformance harness.

The counterpart of ``duckdb_faiss_ext_tpu/harness`` (the reference's Go /
cgo benchmark tier): the three filtered-search strategies (post-filter /
bitmap selector / id-set selector) with the binomial required-k
computation, dataset loaders (synthetic, fvecs / ivecs / bvecs), recall
measurement, TREC run-file emission and scoring, and search-parameter
auto-tuning.  The modules are copies, with two changes: the CPU baseline
of the filtered bench scales with the corpus rows, not the query count,
and the auto-tuner has no graph (efSearch) sweep until the port has
HNSW / NSG.
"""

from .autotune import AutotuneResult, OperatingPoint, autotune_index
from .datasets import load_fvecs, load_ivecs, synthetic_dataset
from .filtered import FilteredBenchResult, required_k, run_filtered_bench
from .recall import recall_at_k

__all__ = [
    "AutotuneResult",
    "OperatingPoint",
    "autotune_index",
    "FilteredBenchResult",
    "required_k",
    "run_filtered_bench",
    "load_fvecs",
    "load_ivecs",
    "synthetic_dataset",
    "recall_at_k",
]
