"""The port's IVF,Flat slice end to end against the JAX package.

train → add → search / search_filter / search_filter_set / search_batched
/ save / load on ``IVFn,Flat`` and ``IDMap,IVFn,Flat`` through
``duckdb_faiss_ext_tpu_torch`` (on the CPU: ``config.device = "cpu"``,
where the list scans run their plain versions) and through
``duckdb_faiss_ext_tpu``.  The two packages' k-means draw different
initial samples (ops/kmeans.py), so parity cases train a JAX index and
carry it into the port with ``from_reference`` or a checkpoint: the same
centroids and lists.  The JAX side then runs both its interpreted Pallas
list scan (``set_kernel_mode("pallas")``) and its default gather path.

Tolerance: distances rtol=1e-5, atol=1e-5·max|distance| (fp32 sums in
another order: the port's list scan takes L2 in difference form, the JAX
gather path in expansion form); labels equal wherever the neighbouring
distances are further apart than that.
"""

import re

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.models.ivf import IVFIndex as JaxIVF
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.models import ivf_serve
from duckdb_faiss_ext_tpu_torch.models.ivf import IVFIndex
from duckdb_faiss_ext_tpu_torch.ops import kmeans


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


def _clustered(seed, n, d, ncl=8, skew=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 5
    which = rng.integers(0, ncl, n)
    if skew:
        which = np.where(rng.random(n) < skew, 0, which)
    return (centers[which]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.3)


def _assert_agree(got, want, xq=None):
    """Same (label, distance) lists up to fp32 summation order.  With
    ``xq``, the tolerance scales with the largest |q|² too: an L2 distance
    taken in expansion form (the spill scan, in both packages) cancels
    terms of that size."""
    np.testing.assert_array_equal(got["rank"], want["rank"])
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    np.testing.assert_array_equal(got["label"][~finite], want["label"][~finite])
    scale = float(np.abs(wd[finite]).max()) if finite.any() else 1.0
    if xq is not None:
        scale = max(scale, float((xq * xq).sum(1).max()))
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5, atol=tol)
    signed = np.where(finite, wd, np.inf)
    gap = np.abs(np.diff(signed, axis=1)) > 2 * tol
    separated = finite.copy()
    separated[:, 1:] &= gap
    separated[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][separated],
                                  want["label"][separated])


def _jax_both(fn):
    """The JAX package's result through its interpreted Pallas list scan
    and through its default (gather) path."""
    dfx.set_kernel_mode("pallas")
    try:
        pallas = fn()
    finally:
        dfx.set_kernel_mode("auto")
    return pallas, fn()


def _carried(catalog, pcat, factory, metric, xb, ids=None, name="src"):
    """A JAX index trained and filled, and its copy in the port."""
    dfx.faiss_create(name, xb.shape[1], factory, metric_type=metric,
                     catalog=catalog)
    dfx.faiss_add((ids, xb) if ids is not None else xb, name,
                  catalog=catalog)
    pcat.put(name, from_reference(catalog.get(name)))


# --- parity with the JAX package on the same trained state -------------------

@pytest.mark.parametrize("nprobe", ["1", "3", "8"])
@pytest.mark.parametrize("factory,metric", [
    ("IVF8,Flat", "L2"), ("IDMap,IVF8,Flat", "INNER_PRODUCT"),
    ("IDMap,IVF8,Flat", "L2")])
def test_search_matches_jax(catalog, pcat, factory, metric, nprobe):
    xb = _clustered(1, 1500, 16)
    ids = np.arange(1500, dtype=np.int64) * 3 + 7
    _carried(catalog, pcat, factory, metric, xb,
             ids if factory.startswith("IDMap") else None)
    xq = _clustered(2, 12, 16)
    got = dt.faiss_search("src", 10, xq, {"nprobe": nprobe}, catalog=pcat)
    for want in _jax_both(lambda: dfx.faiss_search(
            "src", 10, xq, {"nprobe": nprobe}, catalog=catalog)):
        _assert_agree(got, want)
    stats = dt.faiss_stats("src", catalog=pcat)["indexes"]["src"]
    assert (stats["last_scan_path"], stats["nlist"]) == ("per-query", 8)


@pytest.mark.parametrize("fn", ["faiss_search_filter",
                                "faiss_search_filter_set"])
def test_filtered_search_matches_jax(catalog, pcat, fn):
    xb = _clustered(3, 1200, 8)
    ids = np.arange(1200, dtype=np.int64) + 100
    _carried(catalog, pcat, "IDMap,IVF4,Flat", "L2", xb, ids)
    xq = _clustered(4, 9, 8)
    pdb, jdb = dt.Database(), dfx.Database()
    pdb.register("t", {"id": ids})
    jdb.register("t", {"id": ids})
    got = getattr(dt, fn)("src", 6, xq, "id%2==0", "id", "t",
                          {"nprobe": "2"}, catalog=pcat, database=pdb)
    assert (got["label"][got["label"] >= 0] % 2 == 0).all()
    for want in _jax_both(lambda: getattr(dfx, fn)(
            "src", 6, xq, "id%2==0", "id", "t", {"nprobe": "2"},
            catalog=catalog, database=jdb)):
        _assert_agree(got, want)


def test_elementwise_metric_takes_the_gather_path(catalog, pcat):
    """L1 has no layout plan in either package: the sorted+gather scan,
    equal to the JAX package's and, at full probe, to Flat."""
    xb = _clustered(5, 400, 8)
    xq = _clustered(6, 4, 8)
    _carried(catalog, pcat, "IVF4,Flat", "L1", xb)
    got = dt.faiss_search("src", 5, xq, {"nprobe": "4"}, catalog=pcat)
    assert pcat.get("src").index._last_scan_path == "gather"
    _assert_agree(got, dfx.faiss_search("src", 5, xq, {"nprobe": "4"},
                                        catalog=catalog))
    dt.faiss_create("fl1", 8, "Flat", metric_type="L1", catalog=pcat)
    dt.faiss_add(xb, "fl1", catalog=pcat)
    _assert_agree(got, dt.faiss_search("fl1", 5, xq, catalog=pcat))


def _small_budget(idx, d):
    """Cap the padded layout at lmax 256 over 8 lists."""
    idx.LAYOUT_BUDGET_BYTES = 8 * 256 * d * 4
    idx.SPILL_FRACTION_MAX = 1.0


def test_spill_layout_matches_jax(catalog, pcat):
    """A layout budget so small that the giant list is capped: the spill
    region is scanned and merged, in both packages (tests/test_ivf.py::
    test_ivf_spill_layout_parity), plain and filtered."""
    d = 16
    xb = _clustered(44, 4000, d, skew=0.7)
    xq = xb[:8]
    _carried(catalog, pcat, "IVF8,Flat", "L2", xb)
    jidx, pidx = catalog.get("src").index, pcat.get("src").index
    jidx.PALLAS_LAYOUT_BUDGET_BYTES = 8 * 256 * d * 4
    jidx.SPILL_FRACTION_MAX = 1.0
    jidx._pallas_plan_cache = jidx._device_pallas = None
    _small_budget(pidx, d)
    pidx._invalidate()
    assert pidx._layout_plan() == ("spill", 256)
    sel_p = dt.SetSelector(np.arange(0, 4000, 2))
    sel_j = dfx.SetSelector(np.arange(0, 4000, 2))
    for ps, js in ((None, None), (sel_p, sel_j)):
        got = dt.faiss_search("src", 10, xq, {"nprobe": "8"}, catalog=pcat,
                              selector=ps)
        assert pidx._spill is not None and pidx._spill.n > 0
        for want in _jax_both(lambda: dfx.faiss_search(
                "src", 10, xq, {"nprobe": "8"}, catalog=catalog,
                selector=js)):
            _assert_agree(got, want, xq)


def test_k_beyond_capped_layout(catalog, pcat):
    """k larger than nprobe x capped lmax returns the spill region's rows
    too (tests/test_ivf.py::test_ivf_spill_k_beyond_capped_layout)."""
    d, k = 8, 400
    xb = _clustered(70, 4000, d, skew=0.7)
    _carried(catalog, pcat, "IVF8,Flat", "L2", xb)
    pidx = pcat.get("src").index
    _small_budget(pidx, d)
    pidx._invalidate()
    got = dt.faiss_search("src", k, xb[:4], {"nprobe": "1"}, catalog=pcat)
    want = dfx.faiss_search("src", k, xb[:4], {"nprobe": "1"},
                            catalog=catalog)
    for q in range(4):
        g = got["label"][q][got["label"][q] >= 0]
        w = want["label"][q][want["label"][q] >= 0]
        assert len(g) == len(w) > 256
        assert set(g.tolist()) == set(w.tolist())
    np.testing.assert_allclose(np.sort(got["distance"], 1),
                               np.sort(want["distance"], 1), rtol=1e-4,
                               atol=1e-4)


def test_pairs_path_matches_jax(catalog, pcat):
    """The pair-tile path forced at a tiny shape with PAIRS_MIN_WORK = 0 in
    both packages (tests/test_pallas_pairs.py::
    test_pairs_flat_path_end_to_end)."""
    rng = np.random.default_rng(23)
    xb = rng.standard_normal((4000, 16)).astype(np.float32)
    xq = xb[:256] + 0.01
    _carried(catalog, pcat, "IVF16,Flat", "L2", xb)
    saved = JaxIVF.PAIRS_MIN_WORK
    JaxIVF.PAIRS_MIN_WORK = 0
    pidx = pcat.get("src").index
    pidx.PAIRS_MIN_WORK = 0
    try:
        got = dt.faiss_search("src", 10, xq, {"nprobe": "4"}, catalog=pcat)
        assert pidx._last_scan_path == "pairs-flat"
        pallas, gather = _jax_both(lambda: dfx.faiss_search(
            "src", 10, xq, {"nprobe": "4"}, catalog=catalog))
        assert catalog.get("src").index._last_scan_path == "pairs-flat"
    finally:
        JaxIVF.PAIRS_MIN_WORK = saved
    _assert_agree(got, pallas)
    _assert_agree(got, gather)
    pidx.PAIRS_MIN_WORK = IVFIndex.PAIRS_MIN_WORK
    _assert_agree(dt.faiss_search("src", 10, xq, {"nprobe": "4"},
                                  catalog=pcat), got)
    assert pidx._last_scan_path == "per-query"


@pytest.mark.parametrize("scan", ["ivf_list_search", "ivf_pairs_search"])
def test_large_batch_runs_in_query_blocks(pcat, monkeypatch, scan):
    """A batch whose list-scan temporaries pass SCAN_BLOCK_BYTES runs in
    power-of-two query blocks through either scan, with the results of
    one block."""
    d = 8
    xb = _clustered(27, 1000, d)
    xq = _clustered(28, 100, d)                   # padded to 128 rows
    dt.faiss_create("blk", d, "IVF4,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "blk", catalog=pcat)
    idx = pcat.get("blk").index
    if scan == "ivf_pairs_search":
        idx.PAIRS_MIN_WORK, idx.PAIRS_MIN_BATCH = 0, 1
    params = {"nprobe": "2"}
    whole = dt.faiss_search("blk", 5, xq, params, catalog=pcat)
    lmax = idx._build_device_layout().payload.shape[1]
    idx.SCAN_BLOCK_BYTES = 32 * 4 * 2 * (lmax + d)   # 32 queries a block
    assert idx.query_block(128, 2, lmax) == 32
    blocks = []
    real = getattr(ivf_serve, scan)

    def counted(*args, **kw):
        blocks.append(args[4].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(ivf_serve, scan, counted)
    split = dt.faiss_search("blk", 5, xq, params, catalog=pcat)
    assert blocks == [32] * 4
    _assert_agree(split, whole)


def test_search_batched_matches_search(catalog, pcat):
    xb = _clustered(8, 1000, 8)
    ids = np.arange(1000, dtype=np.int64) * 2
    _carried(catalog, pcat, "IDMap,IVF4,Flat", "L2", xb, ids)
    xq = _clustered(9, 100, 8)
    got = dt.faiss_search_batched("src", 5, xq, {"nprobe": "2"},
                                  batch_size=16, catalog=pcat)
    _assert_agree(got, dt.faiss_search("src", 5, xq, {"nprobe": "2"},
                                       catalog=pcat))
    _assert_agree(got, dfx.faiss_search_batched(
        "src", 5, xq, {"nprobe": "2"}, batch_size=16, catalog=catalog))


def test_search_batched_on_empty_ivf(pcat):
    """An empty trained index has no device work: batched search pads."""
    dt.faiss_create("e", 8, "IVF2,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_manual_train(_clustered(10, 50, 8), "e", catalog=pcat)
    res = dt.faiss_search_batched("e", 3, np.zeros((5, 8), np.float32),
                                  batch_size=2, catalog=pcat)
    assert (res["label"] == -1).all() and np.isposinf(res["distance"]).all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_cross_load(catalog, pcat, tmp_path, direction):
    """A file saved by either package loads in the other and searches to
    the same results; loaded means immutable."""
    xb = _clustered(12, 600, 8)
    ids = np.arange(600, dtype=np.int64) + 5
    xq = _clustered(13, 6, 8)
    if direction == "jax_to_port":
        src, dst = (dfx, catalog), (dt, pcat)
    else:
        src, dst = (dt, pcat), (dfx, catalog)
    src[0].faiss_create("a", 8, "IDMap,IVF4,Flat", metric_type="L2",
                        catalog=src[1])
    src[0].faiss_add((ids, xb), "a", catalog=src[1])
    path = str(tmp_path / "ivf.dfx")
    src[0].faiss_save("a", path, catalog=src[1])
    dst[0].faiss_load("b", path, catalog=dst[1])
    params = {"nprobe": "2"}
    _assert_agree(dst[0].faiss_search("b", 5, xq, params, catalog=dst[1]),
                  src[0].faiss_search("a", 5, xq, params, catalog=src[1]))
    with pytest.raises(dst[0].InvalidInputError, match="immutable"):
        dst[0].faiss_add((ids, xb), "b", catalog=dst[1])


def test_from_reference_carries_centroids(catalog, pcat):
    xb = _clustered(14, 500, 8)
    _carried(catalog, pcat, "IVF4,Flat", "INNER_PRODUCT", xb)
    jidx, pidx = catalog.get("src").index, pcat.get("src").index
    np.testing.assert_array_equal(pidx._centroids, jidx._centroids)
    np.testing.assert_array_equal(pidx._assign, jidx._assign)
    assert pidx.quantizer.ntotal == 4


# --- the slice's own behaviour -----------------------------------------------

def test_full_probe_equals_flat(pcat):
    """Probing every list is exact (tests/test_ivf.py::
    test_ivf_full_probe_matches_flat), with the port's own training."""
    xb = _clustered(15, 500, 16)
    xq = _clustered(16, 6, 16)
    dt.faiss_create("ivf", 16, "IVF8,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "ivf", catalog=pcat)       # deferred train, then add
    dt.faiss_create("flat", 16, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "flat", catalog=pcat)
    _assert_agree(dt.faiss_search("ivf", 5, xq, {"nprobe": "8"},
                                  catalog=pcat),
                  dt.faiss_search("flat", 5, xq, catalog=pcat))


def test_nprobe_subset_recall_and_determinism(pcat):
    xb = _clustered(17, 2000, 16, ncl=16)
    xq = _clustered(18, 8, 16, ncl=16)
    dt.faiss_create("ivf", 16, "IVF16,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "ivf", catalog=pcat)
    dt.faiss_create("flat", 16, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "flat", catalog=pcat)
    rf = dt.faiss_search("flat", 10, xq, catalog=pcat)
    r4 = dt.faiss_search("ivf", 10, xq, {"nprobe": "4"}, catalog=pcat)
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(r4["label"], rf["label"])])
    assert recall >= 0.8, recall
    np.testing.assert_array_equal(
        r4["label"], dt.faiss_search("ivf", 10, xq, {"nprobe": "4"},
                                     catalog=pcat)["label"])


def test_idmap_ivf1_single_labeled_row(pcat):
    """faiss_add_ids_with_train copy.test: IDMap,IVF1,Flat, one row."""
    dt.faiss_create("demo", 2, "IDMap,IVF1,Flat", catalog=pcat)
    dt.faiss_add((np.array([231]),
                  np.array([[0.0040321066, 0.023423655]], np.float32)),
                 "demo", catalog=pcat)
    res = dt.faiss_search("demo", 1, np.array([[0.0, 0.02]], np.float32),
                          catalog=pcat)
    assert res["label"][0, 0] == 231


def test_reconstruct_by_position(pcat):
    xb = _clustered(26, 300, 8)
    dt.faiss_create("r", 8, "IVF4,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "r", catalog=pcat)
    idx = pcat.get("r").index
    np.testing.assert_array_equal(idx.reconstruct(17), xb[17])
    with pytest.raises(dt.InvalidInputError, match="out of range"):
        idx.reconstruct(300)


def test_manual_train_then_add(pcat):
    xb = _clustered(19, 600, 8)
    dt.faiss_create("mt", 8, "IVF4,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_manual_train(xb[:300], "mt", catalog=pcat)
    assert pcat.get("mt").index.ntotal == 0
    dt.faiss_add(xb, "mt", catalog=pcat)
    res = dt.faiss_search("mt", 3, xb[:2], {"nprobe": "4"}, catalog=pcat)
    assert res["label"][0, 0] == 0
    np.testing.assert_allclose(res["distance"][0, 0], 0.0, atol=1e-4)


def test_too_few_training_points_message(catalog, pcat):
    """The same error text as the JAX package (tests/test_ivf.py:55-69),
    and the failed batch is not staged."""
    x = np.random.default_rng(20).random((10, 8), dtype=np.float32)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("big", 8, "IVF64,Flat", catalog=cat)
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_add(x, "big", catalog=cat)
        msgs.append(str(exc.value))
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_manual_train(x, "big", catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[:2] == msgs[2:]
    assert msgs[0].startswith(
        "Index big needs to be trained, but amount of datapoints is too "
        "small. Considere adding more data.")
    assert "at least as large as number of clusters (64)" in msgs[0]
    dt.faiss_add(np.random.default_rng(21).random((128, 8), np.float32),
                 "big", catalog=pcat)
    assert pcat.get("big").index.ntotal == 128


def test_quantiser_params_accepted(pcat):
    xb = _clustered(22, 600, 8)
    dt.faiss_create("q", 8, "IVF4_Flat,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "q", catalog=pcat)
    res = dt.faiss_search("q", 3, xb[:2],
                          {"nprobe": "2", "quantiser.efSearch": "64"},
                          catalog=pcat)
    assert res["label"][0, 0] == 0


@pytest.mark.parametrize("factory,what", [
    ("IVF4_HNSW8,Flat", "IVF quantizer HNSW8"),
    ("IVF4(IVF2,Flat),Flat", "parenthesized IVF quantizer"),
    ("IVF4,SQfp16", "IVF encoding SQfp16"),
    ("IVF4,PQ4,RFlat", "RFlat"),
    ("IMI2x2,Flat", "IMI")])
def test_unported_ivf_forms_refused(pcat, factory, what):
    with pytest.raises(dt.InvalidInputError,
                       match=f"{what} is not yet available in "
                             f"duckdb_faiss_ext_tpu_torch"):
        dt.faiss_create("e", 8, factory, catalog=pcat)
    assert pcat.names() == []


@pytest.mark.parametrize("key", ["soar_lambda", "anisotropic_eta", "beam",
                                 "assign_topk"])
def test_unported_create_params_refused(catalog, pcat, key):
    """soar_lambda is not yet available; anisotropic_eta and beam are
    ported and refused on Flat storage with the JAX package's own messages;
    assign_topk (capped device-ingest assignment) is ported and accepted
    and stored, as in the JAX package."""
    if key == "assign_topk":
        dfx.faiss_create_params("e", 8, "IVF4,Flat", {key: "4"},
                                catalog=catalog)
        dt.faiss_create_params("e", 8, "IVF4,Flat", {key: "4"}, catalog=pcat)
        assert (pcat.get("e").index.assign_topk
                == catalog.get("e").index.assign_topk == 4)
        return
    if key in ("anisotropic_eta", "beam"):
        with pytest.raises(dfx.InvalidInputError) as want:
            dfx.faiss_create_params("e", 8, "IVF4,Flat", {key: "1"},
                                    catalog=catalog)
        assert "applies to" in str(want.value)
        match = f"^{re.escape(str(want.value))}$"
    else:
        match = "not yet available"
    with pytest.raises(dt.InvalidInputError, match=match):
        dt.faiss_create_params("e", 8, "IVF4,Flat", {key: "1"}, catalog=pcat)
    assert pcat.names() == []


# --- the port's own k-means --------------------------------------------------

def test_kmeans_deterministic_under_train_seed(pcat):
    xb = _clustered(23, 800, 8)
    cents = []
    for name, seed in (("a", 5), ("b", 5), ("c", 6)):
        dt.faiss_create_params(name, 8, "IVF8,Flat", {"train_seed": seed},
                               metric_type="L2", catalog=pcat)
        dt.faiss_manual_train(xb, name, catalog=pcat)
        cents.append(pcat.get(name).index._centroids)
    np.testing.assert_array_equal(cents[0], cents[1])
    assert not np.array_equal(cents[0], cents[2])


def test_kmeans_spherical_for_inner_product(pcat):
    xb = _clustered(24, 800, 8)
    dt.faiss_create("ip", 8, "IVF8,Flat", catalog=pcat)   # INNER_PRODUCT
    dt.faiss_manual_train(xb, "ip", catalog=pcat)
    np.testing.assert_allclose(
        np.linalg.norm(pcat.get("ip").index._centroids, axis=1), 1.0,
        rtol=1e-5)


def _numpy_lloyd(x, c, counts, balance, spherical):
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    d2 = ((x64[:, None, :] - c64[None]) ** 2).sum(-1)
    if balance:
        navg = max(len(x) / len(c), 1.0)
        over = np.clip(counts / navg - 1.0, 0.0, 2.0)
        d2 = d2 + balance * d2.min(1).mean() * 0.5 * over[None]
    lab = d2.argmin(1)
    new_counts = np.bincount(lab, minlength=len(c)).astype(np.float64)
    sums = np.zeros_like(c64)
    np.add.at(sums, lab, x64)
    new = sums / np.maximum(new_counts, 1)[:, None]
    if spherical:
        new /= np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-20)
    return np.where((new_counts > 0)[:, None], new, c64), new_counts


@pytest.mark.parametrize("balance,spherical", [(0.0, False), (1.0, False),
                                               (0.0, True)])
def test_kmeans_step_equals_numpy(balance, spherical):
    """One Lloyd step from a fixed init equals a float64 numpy reference;
    the far-away centroid 5 gets no points and keeps its place."""
    rng = np.random.default_rng(25)
    x = rng.standard_normal((300, 6)).astype(np.float32)
    c = x[:6].copy()
    c[5] = 100.0
    counts = np.array([90, 10, 60, 40, 100, 0], np.float32)
    got, got_counts = kmeans.lloyd_step(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(counts),
        balance=balance, spherical=spherical)
    want, want_counts = _numpy_lloyd(x, c, counts, balance, spherical)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert want_counts[5] == 0
    np.testing.assert_array_equal(got.numpy()[5], c[5])
