"""The one search epilogue of duckdb_faiss_ext_tpu_torch.

Every family's ``search_dispatch`` returns a ``models.base.Dispatch`` that
carries its own label tables (and, under SOAR, its duplicates' key), and
one function, ``finish_dispatches``, fetches, maps, deduplicates and pads
it.  So ``faiss_search``, ``faiss_search_batched`` (many dispatches, one
fetch) and ``Index.search`` answer alike for every family, wrapper,
layout and filter.
"""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.models.ivf import IVFIndex
from duckdb_faiss_ext_tpu_torch.ops.selectors import SetSelector
from duckdb_faiss_ext_tpu_torch.params import as_params

N, D, K = 600, 32, 5

#: (factory string, create parameters, search parameters, filtered,
#: unpadded IVF layout)
CASES = {
    "flat": ("Flat", {}, {}, False, False),
    "idmap-flat": ("IDMap,Flat", {}, {}, False, False),
    "ivf": ("IVF16,Flat", {}, {"nprobe": "3"}, False, False),
    "ivf-filtered": ("IVF16,Flat", {}, {"nprobe": "3"}, True, False),
    "ivf-unpadded": ("IVF16,Flat", {}, {"nprobe": "3"}, False, True),
    "ivf-unpadded-filtered": ("IVF16,Flat", {}, {"nprobe": "3"}, True, True),
    "idmap-ivf-soar": ("IDMap,IVF16,Flat", {"soar_lambda": "1.0"},
                       {"nprobe": "3"}, False, False),
    "ivf-sq8": ("IVF16,SQ8", {}, {"nprobe": "3"}, False, False),
    "ivf-pq8": ("IVF16,PQ8", {}, {"nprobe": "3"}, False, False),
    "lsh": ("LSH", {}, {}, False, False),
    "hnsw-exact": ("HNSW32", {}, {"exact": "true"}, False, False),
    "pca-flat": ("PCA16,Flat", {}, {}, False, False),
}


@pytest.fixture
def cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.mark.parametrize("case", list(CASES))
def test_search_paths_answer_alike(cpu, monkeypatch, case):
    """faiss_search, faiss_search_batched (batches of 3 over 7 queries, one
    fetch) and Index.search give identical labels and distances: the
    batched search those of faiss_search over the same batches, and,
    where no transform rounds by batch, over all 7."""
    factory, create, params, filtered, unpadded = CASES[case]
    if unpadded:
        monkeypatch.setattr(IVFIndex, "LAYOUT_BUDGET_BYTES", 1 << 10)
    rng = np.random.default_rng(23)
    xb = rng.standard_normal((N, D)).astype(np.float32)
    xq = rng.standard_normal((7, D)).astype(np.float32)
    xq[2] = xb[10]
    cat = dt.Catalog()
    dt.faiss_create_params("i", D, factory, create, catalog=cat,
                           metric_type="L2")
    if factory.startswith("IDMap"):
        dt.faiss_add((np.arange(N) * 3 + 11, xb), "i", catalog=cat)
    else:
        dt.faiss_add(xb, "i", catalog=cat)
    index = cat.get("i").index
    sel = (SetSelector(index.row_labels()[::2]) if filtered else None)

    def search(q):
        res = dt.faiss_search("i", K, q, params, catalog=cat, selector=sel)
        return res["label"], res["distance"]

    one = search(xq)
    res = dt.faiss_search_batched("i", K, xq, params, batch_size=3,
                                  catalog=cat, selector=sel)
    batched = res["label"], res["distance"]
    direct = index.search(xq, K, as_params(params), sel)
    parts = [search(xq[s:s + 3]) for s in range(0, 7, 3)]
    per_batch = tuple(np.concatenate(p) for p in zip(*parts))
    pairs = [(batched, per_batch), ((direct.labels, direct.distances), one)]
    if not factory.startswith("PCA"):
        # (the PCA matmul rounds a batch of 3 rows apart from one of 7)
        pairs.append((per_batch, one))
    for got, want in pairs:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if unpadded:
        assert index._last_scan_path == "unpadded"
    labels = one[0]
    assert labels.shape == (7, K)
    found = labels[labels >= 0]
    assert found.size > 0
    assert np.isin(found, index.row_labels()).all()
    for row in labels:        # (SOAR stores each row twice)
        assert np.unique(row[row >= 0]).size == (row >= 0).sum()
    if filtered:
        assert sel.contains(found).all()
