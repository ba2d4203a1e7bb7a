"""duckdb_faiss_ext_tpu_torch — the PyTorch / CUDA port of duckdb_faiss_ext_tpu.

The same ``faiss_*`` surface as the JAX package (the reference extension's
SQL functions: named index create / add / search / filtered search / save /
load / destroy), with the same error messages, result schema and checkpoint
format, running on an NVIDIA H100.  The port covers the ``Flat`` and
``IDMap,Flat`` families, the ``IVFn,Flat`` / ``IDMap[2],IVFn,Flat``
families and the standalone scalar quantizers ``SQ8`` / ``SQ4`` / ``SQ6``
/ ``SQfp16`` / ``SQbf16`` over all nine metrics, and, under L2 and inner
product (with IDMap), ``IVFn,SQ8`` / ``SQ4`` / ``SQ6`` / ``SQfp16`` /
``SQbf16``, the PQ / RQ codecs ``PQm[xb]`` / ``RQMxb`` and their residual
IVF forms ``IVFn,PQm[xb]`` / ``IVFn,RQMxb``.  Around it: the SQL shell
(``python -m duckdb_faiss_ext_tpu_torch``, ``sql.dispatch``,
``sql.logictest``), the harness (``harness``: filtered bench, datasets,
recall, TREC, autotune) and the port bench
(``python3 -m duckdb_faiss_ext_tpu_torch.bench``).
L2 and inner-product search run through hand-written CUDA kernels:
``csrc/flat_topk.cu`` (Flat), ``csrc/ivf_list_scan.cu`` and
``csrc/ivf_pairs.cu`` (IVF list scans), ``csrc/ivf_sq_scan.cu``,
``csrc/ivf_sq_pairs.cu`` and ``csrc/sq_spill.cu`` (the int8 IVF,SQ scans,
with ``set_sq_dot``) and ``csrc/ivf_pq_scan.cu`` (the IVF-PQ / IVF-RQ
gather-decode-score scan); large IVF batches take the pipelined pair-tile
kernels ``csrc/ivf_pairs_mega.cu`` / ``csrc/ivf_sq_pairs_mega.cu`` under
``config.pairs_impl = "mega"``.  ``faiss_train_device`` /
``faiss_add_device`` build an IVF,Flat or IVF,SQ layout on the card from
rows already there.

Every index keeps its corpus on ``config.device`` (``"cuda"`` by default;
``set_device("cpu")`` runs the plain torch paths on the CPU).
"""

from .api import (
    RESULT_DTYPE,
    create_mask,
    faiss_add,
    faiss_add_device,
    faiss_create,
    faiss_create_params,
    faiss_destroy,
    faiss_load,
    faiss_manual_train,
    faiss_save,
    faiss_search,
    faiss_search_batched,
    faiss_search_filter,
    faiss_search_filter_set,
    faiss_stats,
    faiss_train_device,
    register_create_parameter,
)
from .catalog import GLOBAL_CATALOG, Catalog, IndexEntry
from .errors import InvalidInputError
from .factory import build_index
from .metrics import metric_names, resolve_metric
from .ops.selectors import BitmapSelector, SetSelector
from .params import ParamMap
from .sql import Database, register_table
from .utils.config import config, set_device, set_precision, set_sq_dot

__version__ = "0.1.0"

__all__ = [
    "RESULT_DTYPE",
    "create_mask",
    "faiss_add",
    "faiss_add_device",
    "faiss_create",
    "faiss_create_params",
    "faiss_destroy",
    "faiss_load",
    "faiss_manual_train",
    "faiss_save",
    "faiss_search",
    "faiss_search_batched",
    "faiss_search_filter",
    "faiss_search_filter_set",
    "faiss_stats",
    "faiss_train_device",
    "GLOBAL_CATALOG",
    "Catalog",
    "IndexEntry",
    "InvalidInputError",
    "build_index",
    "metric_names",
    "resolve_metric",
    "BitmapSelector",
    "SetSelector",
    "ParamMap",
    "Database",
    "config",
    "register_create_parameter",
    "register_table",
    "set_device",
    "set_precision",
    "set_sq_dot",
]
