"""The port's sharded graph regime (HNSW / NSG under faiss_to_device)
against the JAX package's ``graph_sharded``, 8 ways on the CPU.

The JAX side walks without packed neighbourhoods (``pack_budget_bytes`` 0,
``_graph_pack`` None: not ported), and both walk with a frontier of 8.
Both packages cut the corpus into the same row blocks; where a block's build is the exact k-NN scan the per-shard
graphs are the same and the walks agree (distances within 1e-5 of the
larger of the batch's largest |distance| and |q|², labels equal wherever
neighbouring distances are further apart than twice that); where the
build is clustered (blocks past ``graph_max`` rows) the packages' k-means
differ, so the graphs differ and their edge recall against each block's
exact k-NN graph agrees within 0.02.  A filtered search takes the sharded
exact scan in both.
"""

import numpy as np
import pytest
import torch
from jax import lax

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.ops import graph as jg
from duckdb_faiss_ext_tpu.ops.selectors import SetSelector as JSetSelector
from duckdb_faiss_ext_tpu.parallel import sharded as jsh
from duckdb_faiss_ext_tpu_torch.io.convert import component
from duckdb_faiss_ext_tpu_torch.parallel import sharded as psh

TOL = 1e-5


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture(autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clustered(n, d, seed=0, ncenters=32, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncenters, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, ncenters, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


def assert_agree(got, want, xq):
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    scale = max(float(np.abs(wd[finite]).max()), float((xq * xq).sum(1).max()))
    tol = TOL * scale
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=0, atol=tol)
    gap = np.abs(np.diff(np.where(finite, wd, 1e30), axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][sep], want["label"][sep])


class Both:
    """The same graph index in both packages, each filled by its own add
    and placed 8 ways."""

    def __init__(self, factory, xb, *, metric="L2", ids=None, params=None,
                 graph_max=None, place=True):
        self.cats = (dfx.Catalog(), dt.Catalog())
        self.index = []
        for mod, cat in zip((dfx, dt), self.cats):
            mod.faiss_create_params("g", xb.shape[1], factory, params or {},
                                    metric_type=metric, catalog=cat)
            ix = component(cat.get("g").index)
            ix.ann_threshold = 1000
            if graph_max is not None:
                ix.graph_max = graph_max
            if mod is dfx:
                ix.pack_budget_bytes = 0
                ix._graph_pack = lambda *a: None
            mod.faiss_add((ids, xb) if ids is not None else xb, "g",
                          catalog=cat)
            self.index.append(ix)
        if place:
            dfx.faiss_to_device("g", jsh.make_mesh(8), catalog=self.cats[0])
            dt.faiss_to_device("g", psh.make_mesh(8), catalog=self.cats[1])

    def search(self, k, xq, params=None, jsel=None, psel=None):
        # The JAX package's sharded walk needs the frontier (graph_width)
        # within the pool; its default (512 / degree) is wider than a
        # small efSearch's pool.
        params = dict({"graph_width": "8"}, **(params or {}))
        return (dfx.faiss_search("g", k, xq, params, catalog=self.cats[0],
                                 selector=jsel),
                dt.faiss_search("g", k, xq, params, catalog=self.cats[1],
                                selector=psel))

    def graphs(self):
        """Per-shard (jax, port) adjacency blocks and valid rows."""
        jgs, pgs = self.index[0]._graph_sharded, self.index[1]._graph_sharded
        rows = pgs[1][0][torch.device("cpu")].shape[0]
        jadj = np.asarray(jgs[1])
        return [(jadj[s * rows:(s + 1) * rows], pgs[1][s][torch.device("cpu")]
                 .numpy(), int(pgs[2][s])) for s in range(len(pgs[1]))]


def test_same_row_blocks():
    """Both packages cut the placed buffer into the same 8 blocks, with the
    same valid rows a block, and build one graph a block."""
    xb = _clustered(3000, 16, seed=1)
    both = Both("HNSW8", xb)
    both.search(5, xb[:4])
    jix, pix = both.index
    assert pix._effective_mode() == jix._effective_mode() == "graph_sharded"
    jgs, pgs = jix._graph_sharded, pix._graph_sharded
    assert pgs[0] == jgs[0] == jix.device_vectors().shape[0]
    np.testing.assert_array_equal(np.asarray(pgs[2]), np.asarray(jgs[2]))
    assert pgs[3] == jgs[3] == 3000
    for jadj, padj, n_s in both.graphs():
        assert padj.shape == jadj.shape
        assert (padj[n_s:] == -1).all()
        assert ((padj[:n_s] >= -1) & (padj[:n_s] < n_s)).all()


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_exact_build_walk_parity(metric):
    """Blocks within graph_max: the exact k-NN build, the same graphs, and
    walks equal to the JAX package's; a pool of every block's rows makes
    the walk exhaustive, equal to the exact search."""
    xb = _clustered(4000, 16, seed=2)
    if metric == "INNER_PRODUCT":
        xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    xq = xb[:24] + 0.05
    both = Both("HNSW8", xb, metric=metric)
    for ef in ("16", "32"):
        jres, pres = both.search(10, xq, {"efSearch": ef})
        assert_agree(pres, jres, xq)
    for jadj, padj, n_s in both.graphs():
        assert (jadj[:n_s] == padj[:n_s]).mean() > 0.99
    jres, pres = both.search(10, xq, {"efSearch": "1024"})
    exact = dt.faiss_search("g", 10, xq, {"exact": "true"},
                            catalog=both.cats[1])
    assert_agree(pres, jres, xq)
    assert_agree(pres, exact, xq)


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_clustered_build_edge_recall_within_jax(metric):
    """Blocks past graph_max rows: the clustered build in both; the edge
    recall of the per-shard graphs against each block's exact k-NN graph
    agrees within 0.02."""
    n, d = 8000, 16
    xb = _clustered(n, d, seed=3, ncenters=64)
    if metric == "INNER_PRODUCT":
        xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    both = Both("HNSW8", xb, metric=metric, graph_max=400)
    both.search(5, xb[:4])
    jr, pr = [], []
    rows = n // 8
    for s, (jadj, padj, n_s) in enumerate(both.graphs()):
        block = xb[s * rows:s * rows + n_s]
        exact = jg.build_knn_graph(block, jadj.shape[1], metric,
                                   precision=lax.Precision.HIGHEST)
        for adj, out in ((jadj, jr), (padj, pr)):
            out.append(np.mean([len(set(a[a >= 0]) & set(b)) / len(b)
                                for a, b in zip(adj[:n_s], exact)]))
    assert abs(np.mean(pr) - np.mean(jr)) <= 0.02, (pr, jr)


def test_filtered_search_takes_the_sharded_exact_scan():
    xb = _clustered(3000, 16, seed=4)
    ids = np.arange(3000, dtype=np.int64) * 7
    both = Both("IDMap,HNSW8", xb, ids=ids)
    keep = ids[::3]
    xq = xb[:8] + 0.05
    jres, pres = both.search(6, xq, {"efSearch": "16"}, JSetSelector(keep),
                             dt.SetSelector(keep))
    exact = dt.faiss_search("g", 6, xq, {"exact": "true"},
                            catalog=both.cats[1],
                            selector=dt.SetSelector(keep))
    assert_agree(pres, jres, xq)
    np.testing.assert_array_equal(pres["label"], exact["label"])
    assert (pres["label"] % 21 == 0).all()
    assert both.index[1]._graph_sharded is None     # no build for it


def test_tail_merge_and_rebuild():
    """Rows added after the per-shard build are scanned exactly (K1 on
    every block) and merged; past the rebuild fraction the graphs are built
    again."""
    xb = _clustered(5000, 16, seed=5)
    both = Both("HNSW8", xb[:4000])
    xq = xb[4000:4016] + 0.01
    both.search(10, xq, {"efSearch": "1024"})
    pix = both.index[1]
    built = pix._graph_sharded
    for mod, cat in zip((dfx, dt), both.cats):
        mod.faiss_add(xb[4000:4090], "g", catalog=cat)    # fits 4096 rows
    jres, pres = both.search(10, xq, {"efSearch": "1024"})
    assert pix._graph_sharded is built
    assert_agree(pres, jres, xq)
    assert (pres["label"][:, 0] >= 4000).all()
    for mod, cat in zip((dfx, dt), both.cats):
        mod.faiss_add(xb[4090:], "g", catalog=cat)
    jres, pres = both.search(10, xq, {"efSearch": "1024"})
    assert pix._graph_sharded is not built and pix._graph_sharded[3] == 5000
    assert_agree(pres, jres, xq)


def test_placement_keeps_the_host_graph():
    """Placing a built index drops the single-device walk's adjacency but
    keeps the host graph (saved, reused unplaced); the walk then runs per
    shard."""
    xb = _clustered(3000, 16, seed=6)
    cat = dt.Catalog()
    dt.faiss_create_params("h", 16, "HNSW8", {"ann_threshold": "1000"},
                           metric_type="L2", catalog=cat)
    dt.faiss_add(xb, "h", catalog=cat)
    dt.faiss_search("h", 5, xb[:4], catalog=cat)
    ix = cat.get("h").index
    host = ix._graph
    assert host is not None and ix._graph_dev is not None
    dt.faiss_to_device("h", psh.make_mesh(4), catalog=cat)
    assert ix._graph is host and ix._graph_dev is None
    res = dt.faiss_search("h", 5, xb[:4], {"efSearch": "1024"}, catalog=cat)
    assert len(ix._graph_sharded[1]) == 4
    assert (res["label"][:, 0] == np.arange(4)).all()
    assert ix.search_dispatch(xb[:4], 5) is None    # no batched walk


def test_ivf_regime_under_placement_is_exact():
    """accel=ivf (single-device only) falls to the sharded exact scan."""
    xb = _clustered(3000, 16, seed=7)
    both = Both("HNSW8", xb, params={"accel": "ivf"})
    assert both.index[1]._effective_mode() == "exact"
    assert both.index[0]._effective_mode() == "exact"
    xq = xb[:6] + 0.05
    jres, pres = both.search(5, xq)
    assert_agree(pres, jres, xq)
