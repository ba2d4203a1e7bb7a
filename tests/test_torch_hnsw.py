"""The port's HNSW / NSG indexes and the IVF coarse quantizers against the
JAX package's, through the public API (tests/test_graph.py:190-504 and
tests/test_pq_hnsw.py:69-110, 193-337, 437, tests/test_ivf.py:131).

The JAX side walks without its packed neighbourhoods: its instance's
``_graph_pack`` returns None (lowering ``pack_budget_bytes`` would also cut
its degree to 16), so both walks score fp32 rows.  Each index is held
against the JAX package twice: with the JAX package's built state carried
across (``from_reference``: the adjacency, the IVF partition, the
centroids), and after its own build.  Tolerance: distances within 1e-5 of
the larger of the batch's largest |distance| and |q|², labels equal
wherever neighbouring distances are further apart than that.  The
pack, int4, coded, folded and sharded cases of tests/test_graph.py are not
here: that code is not ported.
"""

import threading

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.io.convert import component, from_reference
from duckdb_faiss_ext_tpu_torch.models.hnsw import NSGIndex
from duckdb_faiss_ext_tpu_torch.ops import flat_topk
from duckdb_faiss_ext_tpu_torch.ops import graph as graph_ops
from duckdb_faiss_ext_tpu_torch.params import ParamMap


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: these tests issue many small ops,
    which torch's thread pool slows tenfold when test workers share the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pcat():
    return dt.Catalog()


def _clustered(n, d, seed=0, ncenters=32, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncenters, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, ncenters, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


def assert_agree(got, want, xq):
    """``want`` at k or one wider (then the k-th label is checked only
    where the (k+1)-th distance is apart from it)."""
    k = got["label"].shape[1]
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd[:, :k])
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    np.testing.assert_array_equal(got["label"][~finite],
                                  want["label"][:, :k][~finite])
    live = np.isfinite(wd)
    scale = max(float(np.abs(wd[live]).max()) if live.any() else 1.0,
                float((xq * xq).sum(1).max()))
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd[finite], wd[:, :k][finite], rtol=0,
                               atol=tol)
    gap = np.abs(np.diff(np.where(live, wd, 1e30), axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap[:, :k - 1]
    if wd.shape[1] > k:
        sep &= gap[:, :k]
    else:
        sep[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][sep],
                                  want["label"][:, :k][sep])


def _both(catalog, pcat, name, factory, xb, *, params=None, ids=None,
          metric="L2", threshold=1000, **attrs):
    """The same index in both packages, the JAX one unpacked; the port's
    filled by its own add.  Returns (jax index, port index)."""
    out = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create_params(name, xb.shape[1], factory, params or {},
                                metric_type=metric, catalog=cat)
        index = component(cat.get(name).index)
        index.ann_threshold = threshold
        for key, value in attrs.items():
            setattr(index, key, value)
        if mod is dfx:
            index._graph_pack = lambda *a: None
        mod.faiss_add((ids, xb) if ids is not None else xb, name,
                      catalog=cat)
        out.append(index)
    return out


def _carry(catalog, pcat, name, new):
    """The JAX index's whole state (built graph or partition included)
    carried into the port as ``new``."""
    pcat.put(new, from_reference(catalog.get(name)))
    return component(pcat.get(new).index)


def _search(name, k, xq, params, catalog, pcat, **kw):
    """(the JAX package's result one wider, the port's)."""
    return (dfx.faiss_search(name, k + 1, xq, params, catalog=catalog, **kw),
            dt.faiss_search(name, k, xq, params, catalog=pcat, **kw))


def _recall(res, ref):
    return np.mean([len(set(a) & set(b)) / len(b)
                    for a, b in zip(res["label"], ref["label"])])


# --- graph regime ------------------------------------------------------------

@pytest.mark.parametrize("factory,metric,params,n", [
    ("HNSW32", "L2", {"efSearch": "64"}, 4000),
    ("HNSW32", "INNER_PRODUCT", {"efSearch": "64"}, 4000),
    ("NSG32", "L2", {"search_L": "64"}, 4000),
    ("HNSW16,SQ8", "L2", {"efSearch": "128"}, 4000),
    ("HNSW16", "L2", {"efSearch": "32"}, 20_000)])
def test_graph_regime_matches_jax(catalog, pcat, factory, metric, params, n):
    """At 20,000 rows the walk's seeds are a strided sample (below 8,192
    graph rows they are every row)."""
    xb = _clustered(n, 16, seed=60)
    if metric == "INNER_PRODUCT":
        xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    jx, px = _both(catalog, pcat, "hg", factory, xb, metric=metric)
    xq = np.concatenate([xb[:8], _clustered(24, 16, seed=61)])
    want, got = _search("hg", 5, xq, params, catalog, pcat)
    assert jx._graph is not None and px._graph is not None
    assert px._accel is None and px._effective_mode() == "graph"
    assert px._graph[0].shape == jx._graph[0].shape
    assert (px._graph[0] == jx._graph[0]).mean() > 0.99
    assert_agree(got, want, xq)
    np.testing.assert_array_equal(got["label"][:8, 0], np.arange(8))
    carried = _carry(catalog, pcat, "hg", "hg2")
    np.testing.assert_array_equal(carried._graph[0], jx._graph[0])
    again = dt.faiss_search("hg2", 5, xq, params, catalog=pcat)
    assert carried._graph[0] is not None
    assert_agree(again, want, xq)
    exact = dt.faiss_search("hg", 5, xq, {"exact": "true"}, catalog=pcat)
    assert _recall(got, exact) > 0.9


def test_storage_label_kept_apart(pcat):
    """``HNSW16,SQ8`` stores fp32 rows; the label does not overwrite the
    Flat buffer's storage (the JAX package's clobber)."""
    dt.faiss_create("h", 8, "HNSW16,SQ8", catalog=pcat)
    index = pcat.get("h").index
    assert index.storage_label == "SQ8" and index.storage == "f32"
    dt.faiss_create("n", 8, "NSG64", catalog=pcat)
    assert pcat.get("n").index.storage_label == "Flat"


def test_tail_merge_and_rebuild(catalog, pcat):
    d, n = 16, 6000
    xb = _clustered(n, d, seed=60)
    jx, px = _both(catalog, pcat, "hg", "HNSW32", xb)
    params = {"efSearch": "64"}
    _search("hg", 5, xb[:4], params, catalog, pcat)
    extra = np.random.default_rng(60).standard_normal(
        (10, d)).astype(np.float32) * 20
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_add(extra, "hg", catalog=cat)
    before = px._graph
    want, got = _search("hg", 3, extra, params, catalog, pcat)
    assert px._graph is before
    assert (got["label"][:, 0] >= n).all()
    assert_agree(got, want, extra)
    more = _clustered(3000, d, seed=61)
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_add(more, "hg", catalog=cat)
    want, got = _search("hg", 3, xb[:2], params, catalog, pcat)
    assert px._graph is not before and px._graph[1] == px.ntotal
    assert_agree(got, want, xb[:2])


def test_selector_matches_jax(catalog, pcat):
    d, n = 8, 3000
    xb = _clustered(n, d, seed=62)
    _both(catalog, pcat, "hs", "HNSW16", xb)
    sel = {mod: mod.SetSelector(np.arange(0, n, 3, dtype=np.int64))
           for mod in (dfx, dt)}
    want = dfx.faiss_search("hs", 5, xb[:6], {"efSearch": "128"},
                            catalog=catalog, selector=sel[dfx])
    got = dt.faiss_search("hs", 5, xb[:6], {"efSearch": "128"},
                          catalog=pcat, selector=sel[dt])
    assert (got["label"] % 3 == 0).all()
    assert_agree(got, want, xb[:6])
    ex = dt.faiss_search("hs", 5, xb[:6], {"exact": "true"}, catalog=pcat,
                         selector=sel[dt])
    assert _recall(got, ex) > 0.8


def test_idmap_custom_labels_and_batched(catalog, pcat):
    """IDMap,HNSW128,Flat (the reference's benchmark string) in the graph
    regime: labels come back in label space, and the single-fetch batched
    search equals the sequential one, with and without a selector."""
    d, n = 16, 4000
    xb = _clustered(n, d, seed=66)
    labels = np.arange(n, dtype=np.int64) * 7 + 3
    _both(catalog, pcat, "bidm", "IDMap,HNSW128,Flat", xb, ids=labels)
    params = {"efSearch": "64"}
    want, got = _search("bidm", 5, xb[:32], params, catalog, pcat)
    np.testing.assert_array_equal(got["label"][:, 0], labels[:32])
    assert_agree(got, want, xb[:32])
    bat = dt.faiss_search_batched("bidm", 5, xb[:32], params, batch_size=8,
                                  catalog=pcat)
    np.testing.assert_array_equal(bat["label"], got["label"])
    np.testing.assert_array_equal(bat["distance"], got["distance"])
    sel = dt.SetSelector(labels[::2])
    bsel = dt.faiss_search_batched("bidm", 5, xb[:16], params, batch_size=8,
                                   catalog=pcat, selector=sel)
    seq = dt.faiss_search("bidm", 5, xb[:16], params, catalog=pcat,
                          selector=sel)
    np.testing.assert_array_equal(bsel["label"], seq["label"])
    assert np.isin(bsel["label"], labels[::2]).all()


def test_batched_dispatch(catalog, pcat):
    d, n = 16, 4000
    xb = _clustered(n, d, seed=69)
    _, px = _both(catalog, pcat, "hgb", "HNSW32", xb)
    params = {"efSearch": "64"}
    seq = dt.faiss_search("hgb", 5, xb[:32], params, catalog=pcat)
    assert px.search_dispatch(xb[:8], 5, ParamMap(params)) \
        is not None
    bat = dt.faiss_search_batched("hgb", 5, xb[:32], params, batch_size=8,
                                  catalog=pcat)
    np.testing.assert_array_equal(bat["label"], seq["label"])
    np.testing.assert_array_equal(bat["distance"], seq["distance"])
    extra = np.random.default_rng(72).standard_normal(
        (6, d)).astype(np.float32) * 20
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_add(extra, "hgb", catalog=cat)
    assert px.search_dispatch(xb[:8], 5, ParamMap(params)) is None
    bt = dt.faiss_search_batched("hgb", 3, extra, params, batch_size=4,
                                 catalog=pcat)
    assert (bt["label"][:, 0] >= n).all()
    want = dfx.faiss_search_batched("hgb", 3, extra, params, batch_size=4,
                                    catalog=catalog)
    assert_agree(bt, want, extra)


def test_single_build_under_threads(pcat, monkeypatch):
    xb = _clustered(3000, 8, seed=90)
    dt.faiss_create("hl", 8, "HNSW16", metric_type="L2", catalog=pcat)
    pcat.get("hl").index.ann_threshold = 1000
    dt.faiss_add(xb, "hl", catalog=pcat)
    calls = []
    orig = graph_ops.build_graph

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(graph_ops, "build_graph", counting)
    errs = []

    def run():
        try:
            dt.faiss_search("hl", 3, xb[:4], {"efSearch": "32"}, catalog=pcat)
        except Exception as e:  # noqa: BLE001  (reported below)
            errs.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs and len(calls) == 1


def test_clustered_build_regime(pcat):
    """Past graph_max rows the graph regime builds through the clustered
    k-NN scan and NN-descent (forced small here)."""
    xb = _clustered(5000, 16, seed=82)
    dt.faiss_create("hgc", 16, "HNSW32", metric_type="L2", catalog=pcat)
    idx = pcat.get("hgc").index
    idx.ann_threshold, idx.graph_max = 1000, 2000
    dt.faiss_add(xb, "hgc", catalog=pcat)
    res = dt.faiss_search("hgc", 5, xb[:10], {"efSearch": "64"},
                          catalog=pcat)
    assert idx._effective_mode() == "graph" and idx._accel is None
    np.testing.assert_array_equal(res["label"][:, 0], np.arange(10))


def test_exact_regime_and_tail_take_k1(catalog, pcat, monkeypatch):
    """The exact regime, {"exact": "true"} and the tail merge run through
    K1's entry (its plain version on the CPU), with equal results to the
    JAX package's."""
    calls = []
    orig = flat_topk.kernel_flat_search

    def counting(*a, **kw):
        calls.append(a[3])
        return orig(*a, **kw)

    monkeypatch.setattr(flat_topk, "kernel_flat_search", counting)
    xb = _clustered(3000, 16, seed=70)
    _both(catalog, pcat, "small", "HNSW16,SQ8", xb, threshold=200_000)
    want, got = _search("small", 5, xb[:6], {"efSearch": "64"}, catalog,
                        pcat)
    assert len(calls) == 1
    assert_agree(got, want, xb[:6])
    _both(catalog, pcat, "big", "HNSW16", xb)
    dt.faiss_search("big", 5, xb[:6], {"exact": "true"}, catalog=pcat)
    assert len(calls) == 2
    _search("big", 5, xb[:6], {"efSearch": "64"}, catalog, pcat)  # builds
    assert len(calls) == 2
    extra = _clustered(10, 16, seed=71) * 3
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_add(extra, "big", catalog=cat)
    want, got = _search("big", 5, extra, {"efSearch": "64"}, catalog, pcat)
    assert len(calls) == 3          # the tail's scan
    assert_agree(got, want, extra)


def test_hnsw_exact_results(catalog, pcat):
    """The exact regime of a small HNSW index equals Flat."""
    xb = _clustered(500, 8, seed=11)
    xq = _clustered(4, 8, seed=12)
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create_params("h", 8, "HNSW16", {"efConstruction": "32"},
                                metric_type="INNER_PRODUCT", catalog=cat)
        mod.faiss_add(xb, "h", catalog=cat)
    dt.faiss_create("f", 8, "Flat", metric_type="INNER_PRODUCT",
                    catalog=pcat)
    dt.faiss_add(xb, "f", catalog=pcat)
    want, got = _search("h", 5, xq, {"efSearch": "64"}, catalog, pcat)
    flat = dt.faiss_search("f", 5, xq, catalog=pcat)
    np.testing.assert_array_equal(got["label"], flat["label"])
    assert_agree(got, want, xq)
    assert pcat.get("h").index.ef_construction == 32


def test_nsg_surface(catalog, pcat):
    xb = _clustered(400, 8, seed=13)
    xq = _clustered(4, 8, seed=14)
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("nsg", 8, "NSG32", metric_type="L2", catalog=cat)
        mod.faiss_add(xb, "nsg", catalog=cat)
    want, got = _search("nsg", 5, xq, {"search_L": "64"}, catalog, pcat)
    assert_agree(got, want, xq)
    index = pcat.get("nsg").index
    assert isinstance(index, NSGIndex)
    assert index.ef_search == 64


@pytest.mark.parametrize("factory,threshold", [
    ("HNSW16", 1000), ("NSG64,SQ8", 200_000), ("IDMap,HNSW32,Flat", 1000)])
def test_save_load_both_ways(catalog, pcat, tmp_path, factory, threshold):
    """A JAX checkpoint (with its built graph) loads into the port, and a
    port checkpoint (with the port's graph) into the JAX package: equal
    adjacency, equal parameters, equal results, no rebuild."""
    d, n = 8, 3000
    xb = _clustered(n, d, seed=63)
    ids = np.arange(n, dtype=np.int64) + 9 if factory.startswith("IDMap") \
        else None
    jx, px = _both(catalog, pcat, "s", factory, xb, ids=ids,
                   threshold=threshold,
                   params={"efConstruction": "77"})
    params = {"efSearch": "256"}
    want, got = _search("s", 5, xb[:6], params, catalog, pcat)
    for src, dst, mod_src, mod_dst, cat_src, cat_dst, ref in (
            (jx, "p_from_j", dfx, dt, catalog, pcat, want),
            (px, "j_from_p", dt, dfx, pcat, catalog, got)):
        path = str(tmp_path / f"{dst}.idx")
        mod_src.faiss_save("s", path, catalog=cat_src)
        mod_dst.faiss_load(dst, path, catalog=cat_dst)
        loaded = component(cat_dst.get(dst).index)
        assert loaded.ef_construction == 77
        assert loaded.ann_threshold == threshold
        if src._graph is not None:
            np.testing.assert_array_equal(loaded._graph[0], src._graph[0])
        else:
            assert loaded._graph is None
        if mod_dst is dfx:
            loaded._graph_pack = lambda *a: None
        res = mod_dst.faiss_search(dst, 5, xb[:6], params, catalog=cat_dst)
        assert_agree(res, ref, xb[:6])
        if src._graph is not None:
            assert loaded._graph[1] == n    # not rebuilt


# --- ivf regime (accel=ivf, SOAR) --------------------------------------------

def test_ivf_regime_matches_jax(catalog, pcat):
    """accel=ivf: the internal partition carried across gives equal
    results; the port's own partition (its own k-means) keeps the recall;
    tail rows merge, a large tail rebuilds."""
    rng = np.random.default_rng(50)
    d, n = 16, 6000
    centers = rng.standard_normal((32, d)).astype(np.float32) * 4
    xb = centers[rng.integers(0, 32, n)] + rng.standard_normal(
        (n, d)).astype(np.float32) * 0.3
    xq = xb[:10]
    jx, px = _both(catalog, pcat, "hacc", "HNSW32", xb,
                   params={"accel": "ivf"})
    params = {"efSearch": "64"}
    want, got = _search("hacc", 5, xq, params, catalog, pcat)
    assert px._accel is not None and px._graph is None
    assert px._accel[0].nlist == jx._accel[0].nlist == 128
    np.testing.assert_array_equal(got["label"][:, 0], np.arange(10))
    exact = dt.faiss_search("hacc", 5, xq, {"exact": "true"}, catalog=pcat)
    assert _recall(got, exact) > 0.9
    carried = _carry(catalog, pcat, "hacc", "hacc2")
    assert_agree(dt.faiss_search("hacc2", 5, xq, params, catalog=pcat),
                 want, xq)
    np.testing.assert_array_equal(carried._accel[0]._assign,
                                  jx._accel[0]._assign)
    extra = centers[:1] + rng.standard_normal((10, d)).astype(np.float32) * .1
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_add(extra, "hacc", catalog=cat)
    before = px._accel
    res = dt.faiss_search("hacc", 3, extra, params, catalog=pcat)
    assert px._accel is before and (res["label"][:, 0] >= n).all()
    more = rng.standard_normal((3000, d)).astype(np.float32)
    dt.faiss_add(more, "hacc", catalog=pcat)
    dt.faiss_search("hacc", 3, xq[:2], catalog=pcat)
    assert px._accel is not before and px._accel[1] == px.ntotal


def test_ivf_regime_selector_and_tail(catalog, pcat):
    rng = np.random.default_rng(51)
    d, n = 8, 3000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    _both(catalog, pcat, "hsel", "HNSW16", xb, params={"accel": "ivf"})
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_add(xb[:200] + 0.001, "hsel", catalog=cat)
    pcat.put("hsel2", from_reference(catalog.get("hsel")))
    sel = {mod: mod.SetSelector(np.arange(0, n + 200, 3, dtype=np.int64))
           for mod in (dfx, dt)}
    want = dfx.faiss_search("hsel", 5, xb[:6], {"efSearch": "512"},
                            catalog=catalog, selector=sel[dfx])
    got = dt.faiss_search("hsel2", 5, xb[:6], {"efSearch": "512"},
                          catalog=pcat, selector=sel[dt])
    assert (got["label"] % 3 == 0).all()
    assert_agree(got, want, xb[:6])
    own = dt.faiss_search("hsel", 5, xb[:6], {"efSearch": "512"},
                          catalog=pcat, selector=sel[dt])
    assert (own["label"] % 3 == 0).all()


def test_ivf_regime_save_load_both_ways(catalog, pcat, tmp_path):
    rng = np.random.default_rng(52)
    d, n = 8, 3000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    jx, px = _both(catalog, pcat, "hsl", "HNSW16", xb,
                   params={"accel": "ivf"})
    params = {"efSearch": "256"}
    want, got = _search("hsl", 5, xb[:6], params, catalog, pcat)
    for src, dst, mod_src, mod_dst, cat_src, cat_dst, ref in (
            (jx, "p", dfx, dt, catalog, pcat, want),
            (px, "j", dt, dfx, pcat, catalog, got)):
        path = str(tmp_path / f"{dst}.idx")
        mod_src.faiss_save("hsl", path, catalog=cat_src)
        mod_dst.faiss_load(dst, path, catalog=cat_dst)
        loaded = cat_dst.get(dst).index
        np.testing.assert_array_equal(loaded._accel[0]._assign,
                                      src._accel[0]._assign)
        assert loaded.accel_mode == "ivf"
        assert_agree(mod_dst.faiss_search(dst, 5, xb[:6], params,
                                          catalog=cat_dst), ref, xb[:6])


def test_soar_partition(catalog, pcat, tmp_path):
    """soar_lambda keeps the IVF regime; the SOAR partition carried across
    gives equal results with no label twice, through a save / load both
    ways too."""
    rng = np.random.default_rng(41)
    d, n = 24, 8000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    xq = rng.standard_normal((32, d)).astype(np.float32)
    jx, px = _both(catalog, pcat, "so", "HNSW32", xb,
                   params={"soar_lambda": "1.0"})
    params = {"efSearch": "32"}
    want, own = _search("so", 10, xq, params, catalog, pcat)
    assert px._accel is not None and px._graph is None
    assert px._accel[0]._nstored == 2 * n
    carried = _carry(catalog, pcat, "so", "so2")
    got = dt.faiss_search("so2", 10, xq, params, catalog=pcat)
    assert_agree(got, want, xq)
    for res in (got, own):
        for row in res["label"]:
            assert len(set(row.tolist())) == len(row)
    assert carried.soar_lambda == 1.0
    path = str(tmp_path / "so.idx")
    dt.faiss_save("so2", path, catalog=pcat)
    dfx.faiss_load("so3", path, catalog=catalog)
    assert_agree(dfx.faiss_search("so3", 10, xq, params, catalog=catalog),
                 got, xq)


# --- IVF coarse quantizers -----------------------------------------------------

@pytest.mark.parametrize("factory,params", [
    ("IVF4_HNSW8,Flat", {"nprobe": "2", "quantiser.efSearch": "64"}),
    ("IVF16(HNSW8),Flat", {"nprobe": "16"}),
    ("IVF8(IVF4,Flat)", {"nprobe": "3"}),
    ("IVF4(IVF2,Flat),PQ4", {"nprobe": "4"}),
    ("IVF4_HNSW8,SQ8", {"nprobe": "2"}),
    ("IDMap,IVF4_HNSW16,Flat", {"nprobe": "4"})])
def test_coarse_quantizers_match_jax(catalog, pcat, tmp_path, factory,
                                     params):
    """Each quantizer form builds, carries the JAX package's trained state
    across with equal results, and reloads with its nested quantizer
    retrained on the centroid table."""
    d = 16
    xb = _clustered(1200, d, seed=20)
    ids = np.arange(1200, dtype=np.int64) * 2 if factory.startswith("IDMap") \
        else None
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("q", d, factory, metric_type="L2",
                         catalog=cat)
        mod.faiss_add((ids, xb) if ids is not None else xb, "q",
                      catalog=cat)
    own = component(pcat.get("q").index)
    jx = component(catalog.get("q").index)
    assert type(own.quantizer).__name__ == type(jx.quantizer).__name__
    assert own.quantizer.ntotal == own.nlist and own.quantizer.is_trained
    xq = _clustered(12, d, seed=21)
    pcat.put("c", from_reference(catalog.get("q")))
    want = dfx.faiss_search("q", 5, xq, params, catalog=catalog)
    assert_agree(dt.faiss_search("c", 5, xq, params, catalog=pcat), want, xq)
    path = str(tmp_path / "q.idx")
    dfx.faiss_save("q", path, catalog=catalog)
    dt.faiss_load("l", path, catalog=pcat)
    loaded = component(pcat.get("l").index)
    assert loaded.quantizer.is_trained
    assert loaded.quantizer.ntotal == loaded.nlist
    np.testing.assert_array_equal(loaded._centroids, jx._centroids)
    assert_agree(dt.faiss_search("l", 5, xq, params, catalog=pcat), want, xq)
    own_res = dt.faiss_search("q", 5, xq, dict(params, nprobe=str(own.nlist)),
                              catalog=pcat)
    flat = dfx.faiss_search("q", 5, xq, dict(params, nprobe=str(jx.nlist)),
                            catalog=catalog)
    if "PQ4" not in factory:
        assert_agree(own_res, flat, xq)


def test_pq_quantizer_too_few_centroids(catalog, pcat):
    """IVF4_PQ2: a PQ2 quantizer trained on 4 centroids needs 256 points;
    both packages raise the same error at the same call."""
    xb = _clustered(600, 8, seed=22)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("pq", 8, "IVF4_PQ2,Flat", catalog=cat)
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_add(xb, "pq", catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert "256" in msgs[1]


def test_quantizer_create_params_scoped(pcat):
    """``ivf.``-scoped create params reach the coarse quantizer."""
    dt.faiss_create_params("q", 8, "IVF4_HNSW8,Flat",
                           {"ivf.efConstruction": "99"}, catalog=pcat)
    assert pcat.get("q").index.quantizer.ef_construction == 99


def test_every_reference_form_builds(catalog, pcat):
    """The HNSW, NSG and coarse-quantizer forms of the JAX package's
    grammar tests build in the port as the same class graph."""
    forms = ["HNSW16", "IDMap,HNSW32,Flat", "IVF4_HNSW8,Flat", "NSG16",
             "NSG16,SQ8", "IVF4(IVF2,Flat)", "IVF4(IVF2,Flat),PQ4",
             "IVF16(HNSW8),Flat", "HNSW", "NSG", "HNSW8,PQ4", "NSG16,PQ4",
             "IVF4_PQ2,PQ4", "OPQ4,IVF4_HNSW8,PQ4", "PCA8,IVF4_HNSW8,SQ8",
             "IDMap,NSG16,SQ4,RFlat", "IVF4_HNSW8,SQbf16",
             "IVF4_HNSW8,SQfp16", "IDMap2,HNSW32", "IVF8(IVF4_HNSW8,Flat),SQ8"]

    def chain(index):
        out = []
        while index is not None:
            out.append(type(index).__name__)
            q = getattr(index, "quantizer", None)
            if q is not None:
                out.append(chain(q))
            index = (getattr(index, "inner", None)
                     or getattr(index, "base", None))
        return out

    for i, desc in enumerate(forms):
        dfx.faiss_create(f"f{i}", 16, desc, catalog=catalog)
        dt.faiss_create(f"f{i}", 16, desc, catalog=pcat)
        assert chain(pcat.get(f"f{i}").index) == chain(
            catalog.get(f"f{i}").index), desc


def check_form_matches_jax(catalog, pcat, factory, *, d=16, params=None,
                           own_exact=True):
    """``factory`` built in both packages from the same rows (with labels
    for IDMap forms).  Where the JAX package raises at the add, the port
    raises the same message there.  Otherwise the JAX index carried across
    answers as it does under ``params`` (``assert_agree``); with
    ``own_exact`` the port's own build (its own k-means) answers as the JAX
    package's with every list probed."""
    xb = _clustered(800, d, seed=len(factory), ncenters=8)
    xq = np.concatenate([xb[:4], _clustered(8, d, seed=99, ncenters=8)])
    data = ((np.arange(800, dtype=np.int64) * 3 + 1, xb)
            if factory.startswith("IDMap") else xb)
    errs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("form", d, factory, metric_type="L2", catalog=cat)
        try:
            mod.faiss_add(data, "form", catalog=cat)
        except mod.InvalidInputError as e:
            errs.append(str(e))
    if errs:
        assert len(errs) == 2 and errs[0] == errs[1], errs
        return
    params = dict(params or {})
    pcat.put("carried", from_reference(catalog.get("form")))
    want = dfx.faiss_search("form", 5, xq, params, catalog=catalog)
    assert_agree(dt.faiss_search("carried", 5, xq, params, catalog=pcat),
                 want, xq)
    if own_exact:
        nlist = getattr(component(catalog.get("form").index), "nlist", 1)
        full = dict(params, nprobe=str(nlist))
        assert_agree(dt.faiss_search("form", 5, xq, full, catalog=pcat),
                     dfx.faiss_search("form", 5, xq, full, catalog=catalog),
                     xq)


#: tests/test_property.py::test_save_load_roundtrip_all_factories's list
ROUNDTRIP_FACTORIES = [
    "Flat", "IDMap,Flat", "IDMap2,Flat", "HNSW16", "IDMap,HNSW32,Flat",
    "IVF4,Flat", "IDMap,IVF4,Flat", "IVF4_HNSW8,Flat", "PQ4", "IVF4,PQ4",
    "SQ8", "SQfp16", "SQ4", "SQ6", "IVF4,SQ8", "IVF4,SQ4", "IVF4,SQfp16",
    "PQ4,RFlat", "IVF4,PQ4,RFlat", "IDMap,PQ4,RFlat", "PCA8,Flat",
    "PCAR8,Flat", "PCAW8,Flat", "L2norm,Flat", "OPQ4,PQ4", "OPQ4_8,IVF4,PQ4",
    "PCA8,SQ8", "IDMap,OPQ4,IVF4,PQ4", "LSH", "LSHr", "LSHt", "LSHrt",
    "LSH24r", "IDMap,LSH", "SQbf16", "IVF4,SQbf16", "RR,Flat", "RR8,Flat",
    "ITQ,Flat", "ITQ8,LSH16", "NSG16", "NSG16,SQ8", "IMI2x2,Flat",
    "IMI2x2,PQ4", "IDMap,IMI2x2,Flat", "IVF4(IVF2,Flat)", "Pad24,Flat",
    "RQ2x4", "IDMap,RQ2x4", "RQ2x4,RFlat", "IVF4,RQ2x4",
    "IVF4(IVF2,Flat),PQ4"]


@pytest.mark.parametrize("desc", ROUNDTRIP_FACTORIES)
def test_save_load_roundtrip_every_factory(pcat, tmp_path, desc):
    """Every form of the JAX package's round-trip list builds in the port
    and survives its own save → load with equal results (the JAX test's
    tolerance: labels equal, distances rtol 1e-6)."""
    rng = np.random.default_rng(7)
    d, n = 16, 600
    xb = rng.random((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) + 5
    dt.faiss_create("rt", d, desc, metric_type="L2", catalog=pcat)
    dt.faiss_add((ids, xb) if desc.startswith("IDMap") else xb, "rt",
                 catalog=pcat)
    a = dt.faiss_search("rt", 4, xb[:3], {"nprobe": "4"}, catalog=pcat)
    path = str(tmp_path / "rt.dfx")
    dt.faiss_save("rt", path, catalog=pcat)
    dt.faiss_load("rtb", path, catalog=pcat)
    b = dt.faiss_search("rtb", 4, xb[:3], {"nprobe": "4"}, catalog=pcat)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-6)
