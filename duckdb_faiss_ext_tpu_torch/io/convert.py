"""Carry an index from the JAX package into this one.

``from_reference`` reads only plain attributes and the ``state_dict()``
numpy arrays of a ``duckdb_faiss_ext_tpu`` index (its factory description,
dimension, metric name and argument, and its state: the corpus or, for
standalone SQ and IVF,SQ, the packed codes and their trained ranges (the
float codecs' fp16 / bf16 row bytes as they are), for PQ / RQ and IVF-PQ /
IVF-RQ the byte codes as they are and the trained codebooks, IDMap's
labels, IVF's ids, list assignments and trained centroids, and the
``assign_topk`` create parameter of device-resident ingest) and rebuilds
the index through this package's factory and ``load_state`` — the
in-memory form of the checkpoint format (io/serialize.py) the two packages
share.  A JAX index trained for device ingest (``faiss_train_device``)
carries its centroids and SQ ranges like any other; one filled by
``faiss_add_device`` carries its rows gathered back by its
``state_dict``, as an ordinary host-path index.  An index so carried has the JAX package's centroids and codebooks,
which the port's own k-means cannot reproduce (ops/kmeans.py).  Nothing of the JAX
package is imported.
"""

from __future__ import annotations

import numpy as np

from ..catalog import IndexEntry
from ..factory import build_index
from ..metrics import resolve_metric


def _as_numpy(tree: dict) -> dict:
    return {k: _as_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def from_reference(index_or_entry) -> IndexEntry:
    """Catalog entry holding this package's copy of a JAX-package ``Index``
    or ``IndexEntry``.  An entry's lifecycle flags (training latch,
    mutability, label latch) carry over; a bare index gets those of a
    freshly filled one."""
    ref = getattr(index_or_entry, "index", index_or_entry)
    index = build_index(int(ref.d), ref.factory_desc,
                        resolve_metric(ref.metric.name),
                        float(ref.metric_arg))
    state = _as_numpy(ref.state_dict())
    index.load_state(state)
    ivf, ref_ivf = getattr(index, "inner", index), getattr(ref, "inner", ref)
    if hasattr(ivf, "assign_topk"):
        ivf.assign_topk = int(getattr(ref_ivf, "assign_topk", 0) or 0)
    if index_or_entry is not ref:
        src = index_or_entry
        return IndexEntry(index=index, needs_training=src.needs_training,
                          is_mutable=src.is_mutable,
                          custom_labels=src.custom_labels, added=src.added)
    return IndexEntry(
        index=index, needs_training=not index.is_trained,
        custom_labels=("labels" in state) if index.ntotal else None,
        added=index.ntotal)
