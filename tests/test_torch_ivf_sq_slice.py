"""The port's IVF,SQ slice end to end against the JAX package.

train → add → search / search_filter / search_batched / save / load on
``IVFn,SQ8`` / ``SQ4`` / ``SQ6`` and ``IDMap,IVFn,SQ8`` through
``duckdb_faiss_ext_tpu_torch`` (on the CPU: ``config.device = "cpu"``,
where the scans run their plain versions) and through
``duckdb_faiss_ext_tpu``.  As for IVF,Flat (tests/test_torch_ivf_slice.py),
the two packages' k-means draw different initial samples, so parity cases
train a JAX index and carry it into the port (``from_reference`` or a
checkpoint): the same centroids, lists and codes.  Then:

* the int8 path (``set_sq_dot("int8")``): the port's padded layout, K2 or
  K3 and K5 (plain versions) and the exact rerank, against the JAX
  package's interpreted Pallas kernels (``set_kernel_mode("pallas")``);
* the decode path (parity mode): both packages' fp32 decode gather scans;
* the int8 gather scan (int8 path, no layout plan) against the JAX
  package's XLA int8 scan.

Tolerance: distances, which every path rescores in fp32, rtol=1e-5 and
atol=1e-5·max|distance| (with ``xq``, also 1e-5·max‖q‖²: the spill
reranks take L2 in expansion form); labels equal wherever the neighbouring
distances are further apart than that.
"""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.models.ivf import IVFIndex as JaxIVF
from duckdb_faiss_ext_tpu.utils.config import config as jax_config
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.models import ivf_serve
from duckdb_faiss_ext_tpu_torch.models.ivf import IVFIndex
from duckdb_faiss_ext_tpu_torch.utils import config as pconfig
from test_torch_hnsw import check_form_matches_jax

D = 24


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev
    dt.set_sq_dot("auto")
    dt.set_precision("parity")


@pytest.fixture
def pcat():
    return dt.Catalog()


def _clustered(seed, n, d=D, ncl=16, skew=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 3
    which = rng.integers(0, ncl, n)
    if skew:
        which = np.where(rng.random(n) < skew, 0, which)
    return (centers[which]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.5)


def _assert_agree(got, want, xq=None):
    """Same (label, distance) lists up to fp32 summation order."""
    np.testing.assert_array_equal(got["rank"], want["rank"])
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    np.testing.assert_array_equal(got["label"][~finite],
                                  want["label"][~finite])
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


def _jax_int8(fn, spill_kernel=True):
    """The JAX package's int8 path through its interpreted Pallas kernels;
    ``spill_kernel`` takes its spill kernel whatever the spill's size
    (the TPU crossover ``spill_pallas_min`` would keep a small one off)."""
    dfx.set_sq_dot("int8")
    dfx.set_kernel_mode("pallas")
    jax_config.spill_impl = "pallas" if spill_kernel else "auto"
    try:
        return fn()
    finally:
        dfx.set_kernel_mode("auto")
        dfx.set_sq_dot("auto")
        jax_config.spill_impl = "auto"


def _carried(catalog, pcat, factory, metric, xb, ids=None, name="src"):
    """A JAX index trained and filled, and its copy in the port."""
    dfx.faiss_create(name, xb.shape[1], factory, metric_type=metric,
                     catalog=catalog)
    dfx.faiss_add((ids, xb) if ids is not None else xb, name,
                  catalog=catalog)
    pcat.put(name, from_reference(catalog.get(name)))


def _inner(cat, name):
    index = cat.get(name).index
    return getattr(index, "inner", index)


def _small_budget(jidx, pidx):
    """Cap both packages' padded layouts at lmax 256 over 16 lists."""
    w = pidx._codes.shape[1]
    jidx.PALLAS_LAYOUT_BUDGET_BYTES = pidx.LAYOUT_BUDGET_BYTES = 16 * 256 * w
    jidx.SPILL_FRACTION_MAX = pidx.SPILL_FRACTION_MAX = 0.9
    jidx._pallas_plan_cache = jidx._device_pallas = None
    pidx._invalidate()


FACTORIES = [("IVF16,SQ8", "L2"), ("IVF16,SQ4", "INNER_PRODUCT"),
             ("IVF16,SQ6", "L2"), ("IDMap,IVF16,SQ8", "INNER_PRODUCT"),
             ("IVF16,SQ4", "L2"), ("IVF16,SQ6", "INNER_PRODUCT")]


# --- parity with the JAX package on the same trained state -------------------

@pytest.mark.parametrize("nprobe", ["2", "16"])
@pytest.mark.parametrize("factory,metric", FACTORIES)
def test_int8_search_matches_jax(catalog, pcat, factory, metric, nprobe):
    """The int8 path: the port's per-query scan (K2's plain version) and
    rerank against the JAX package's interpreted Pallas kernel."""
    xb = _clustered(1, 3000)
    ids = np.arange(3000, dtype=np.int64) * 3 + 7
    _carried(catalog, pcat, factory, metric, xb,
             ids if factory.startswith("IDMap") else None)
    xq = _clustered(2, 12)
    dt.set_sq_dot("int8")
    got = dt.faiss_search("src", 10, xq, {"nprobe": nprobe}, catalog=pcat)
    pidx = _inner(pcat, "src")
    assert pidx._layout_plan() == ("full", None)
    assert pidx._last_scan_path == "per-query"
    want = _jax_int8(lambda: dfx.faiss_search(
        "src", 10, xq, {"nprobe": nprobe}, catalog=catalog))
    assert "perquery-sq" in _inner(catalog, "src")._last_scan_path
    _assert_agree(got, want)


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["SQ4", "SQ6"])
def test_int8_search_odd_d_matches_jax(catalog, pcat, codec, metric):
    """Odd d (tests/test_pallas_topk.py::test_pallas_ivf_sq4_kernel_
    interpret): the pad codes of the last packed group meet zero digits;
    plain and bitmap-filtered searches against the JAX package's Pallas
    path."""
    d = 33
    xb = _clustered(23, 3000, d=d)
    xq = xb[:16]
    _carried(catalog, pcat, f"IVF16,{codec}", metric, xb)
    flags = np.zeros(3000, bool)
    flags[::2] = True
    dt.set_sq_dot("int8")
    for ps, js in ((None, None), (dt.BitmapSelector.from_bool(flags),
                                  dfx.BitmapSelector.from_bool(flags))):
        got = dt.faiss_search("src", 10, xq, {"nprobe": "16"}, catalog=pcat,
                              selector=ps)
        want = _jax_int8(lambda: dfx.faiss_search(
            "src", 10, xq, {"nprobe": "16"}, catalog=catalog, selector=js))
        _assert_agree(got, want)
        if ps is not None:
            assert flags[got["label"][got["label"] >= 0]].all()


@pytest.mark.parametrize("factory,metric", FACTORIES)
def test_decode_search_matches_jax(catalog, pcat, factory, metric):
    """Parity mode: both packages' fp32 decode gather scans."""
    xb = _clustered(3, 2000)
    ids = np.arange(2000, dtype=np.int64) + 11
    _carried(catalog, pcat, factory, metric, xb,
             ids if factory.startswith("IDMap") else None)
    xq = _clustered(4, 9)
    got = dt.faiss_search("src", 8, xq, {"nprobe": "3"}, catalog=pcat)
    assert _inner(pcat, "src")._last_scan_path == "gather"
    assert _inner(pcat, "src")._layout_plan() is None
    _assert_agree(got, dfx.faiss_search("src", 8, xq, {"nprobe": "3"},
                                        catalog=catalog))


@pytest.mark.parametrize("codec", ["SQ8", "SQ4", "SQ6"])
def test_int8_gather_without_layout_plan_matches_jax(catalog, pcat, codec):
    """The int8 path with no layout plan (budget below one 128-slot list):
    both packages' int8 gather scans."""
    xb = _clustered(5, 2000)
    xq = _clustered(6, 10)
    _carried(catalog, pcat, f"IVF16,{codec}", "L2", xb)
    pidx = _inner(pcat, "src")
    pidx.LAYOUT_BUDGET_BYTES = 16
    pidx._invalidate()
    dt.set_sq_dot("int8")
    got = dt.faiss_search("src", 10, xq, {"nprobe": "4"}, catalog=pcat)
    assert pidx._layout_plan() is None
    assert pidx._last_scan_path == "gather-int8"
    dfx.set_sq_dot("int8")
    try:
        want = dfx.faiss_search("src", 10, xq, {"nprobe": "4"},
                                catalog=catalog)
    finally:
        dfx.set_sq_dot("auto")
    _assert_agree(got, want)


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["SQ8", "SQ4", "SQ6"])
def test_spill_plan_matches_jax(catalog, pcat, codec, metric):
    """A capped layout (tests/test_pallas_topk.py::
    test_pallas_ivf_sq8_spill_plan): the padded lists and the spill region
    (K5's plain version for sq8 / sq4, the plain int8 spill scan for sq6)
    merged, against the JAX package's Pallas list scan and spill kernel,
    plain and filtered."""
    xb = _clustered(7, 5000, skew=0.6)
    xq = xb[:16]
    _carried(catalog, pcat, f"IVF16,{codec}", metric, xb)
    jidx, pidx = _inner(catalog, "src"), _inner(pcat, "src")
    _small_budget(jidx, pidx)
    dt.set_sq_dot("int8")
    sel_p = dt.SetSelector(np.arange(0, 5000, 2))
    sel_j = dfx.SetSelector(np.arange(0, 5000, 2))
    for ps, js in ((None, None), (sel_p, sel_j)):
        got = dt.faiss_search("src", 10, xq, {"nprobe": "16"}, catalog=pcat,
                              selector=ps)
        assert pidx._layout_plan() == ("spill", 256)
        assert pidx._spill is not None and pidx._spill.n > 1000
        want = _jax_int8(lambda: dfx.faiss_search(
            "src", 10, xq, {"nprobe": "16"}, catalog=catalog, selector=js))
        _assert_agree(got, want, xq)
        if ps is not None:
            assert (got["label"][got["label"] >= 0] % 2 == 0).all()


def test_spill_kernel_engaged_only_where_the_jax_rule_says(catalog, pcat,
                                                           monkeypatch):
    """K5 takes sq8 / sq4 spills at d ≥ 16 and k ≤ 128; a larger k takes
    the plain int8 spill scan, as in the JAX package."""
    xb = _clustered(8, 5000, skew=0.6)
    _carried(catalog, pcat, "IVF16,SQ8", "L2", xb)
    jidx, pidx = _inner(catalog, "src"), _inner(pcat, "src")
    _small_budget(jidx, pidx)
    dt.set_sq_dot("int8")
    calls = []
    real = ivf_serve.sq_spill_search

    def counted(*args, **kw):
        calls.append(kw["k"])
        return real(*args, **kw)

    monkeypatch.setattr(ivf_serve, "sq_spill_search", counted)
    for k in (10, 200):
        got = dt.faiss_search("src", k, xb[:4], {"nprobe": "2"},
                              catalog=pcat)
        want = _jax_int8(lambda: dfx.faiss_search(
            "src", k, xb[:4], {"nprobe": "2"}, catalog=catalog))
        _assert_agree(got, want, xb[:4])
    assert calls == [10]


def test_pairs_path_matches_jax(catalog, pcat):
    """The pair-tile path (K3's plain version) forced at a tiny shape with
    PAIRS_MIN_WORK = 0 in both packages (tests/test_pallas_pairs.py::
    test_pairs_path_with_spill_merge), with a capped layout and a spill."""
    xb = _clustered(9, 6000, skew=0.5)
    xq = xb[:256] + 0.01
    _carried(catalog, pcat, "IVF16,SQ8", "L2", xb)
    jidx, pidx = _inner(catalog, "src"), _inner(pcat, "src")
    _small_budget(jidx, pidx)
    saved = JaxIVF.PAIRS_MIN_WORK
    JaxIVF.PAIRS_MIN_WORK = 0
    pidx.PAIRS_MIN_WORK = 0
    dt.set_sq_dot("int8")
    try:
        got = dt.faiss_search("src", 10, xq, {"nprobe": "16"}, catalog=pcat)
        assert pidx._last_scan_path == "pairs-sq8"
        want = _jax_int8(lambda: dfx.faiss_search(
            "src", 10, xq, {"nprobe": "16"}, catalog=catalog))
        assert jidx._last_scan_path.endswith("pairs-sq8")
    finally:
        JaxIVF.PAIRS_MIN_WORK = saved
    _assert_agree(got, want, xq)
    assert (got["label"][:, 0] == np.arange(256)).all()
    pidx.PAIRS_MIN_WORK = IVFIndex.PAIRS_MIN_WORK
    _assert_agree(dt.faiss_search("src", 10, xq, {"nprobe": "16"},
                                  catalog=pcat), got, xq)
    assert pidx._last_scan_path == "per-query"


@pytest.mark.parametrize("sq_dot", ["int8", "decode"])
def test_filtered_search_matches_jax(catalog, pcat, sq_dot):
    xb = _clustered(10, 2400)
    ids = np.arange(2400, dtype=np.int64) + 100
    _carried(catalog, pcat, "IDMap,IVF16,SQ8", "L2", xb, ids)
    xq = _clustered(11, 9)
    pdb, jdb = dt.Database(), dfx.Database()
    pdb.register("t", {"id": ids})
    jdb.register("t", {"id": ids})
    dt.set_sq_dot(sq_dot)
    got = dt.faiss_search_filter("src", 6, xq, "id%2==0", "id", "t",
                                 {"nprobe": "4"}, catalog=pcat, database=pdb)
    assert (got["label"][got["label"] >= 0] % 2 == 0).all()

    def jax_call():
        return dfx.faiss_search_filter("src", 6, xq, "id%2==0", "id", "t",
                                       {"nprobe": "4"}, catalog=catalog,
                                       database=jdb)

    _assert_agree(got, _jax_int8(jax_call) if sq_dot == "int8"
                  else jax_call())


def test_search_batched_matches_search(catalog, pcat):
    xb = _clustered(12, 2000)
    ids = np.arange(2000, dtype=np.int64) * 2
    _carried(catalog, pcat, "IDMap,IVF16,SQ8", "L2", xb, ids)
    xq = _clustered(13, 100)
    dt.set_sq_dot("int8")
    got = dt.faiss_search_batched("src", 5, xq, {"nprobe": "3"},
                                  batch_size=16, catalog=pcat)
    _assert_agree(got, dt.faiss_search("src", 5, xq, {"nprobe": "3"},
                                       catalog=pcat))
    _assert_agree(got, _jax_int8(lambda: dfx.faiss_search_batched(
        "src", 5, xq, {"nprobe": "3"}, batch_size=16, catalog=catalog)))


@pytest.mark.parametrize("codec", ["SQ8", "SQ4", "SQ6"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_cross_load(catalog, pcat, tmp_path, direction, codec):
    """A file saved by either package loads in the other and searches to
    the same results on both paths; loaded means immutable."""
    xb = _clustered(14, 1500)
    ids = np.arange(1500, dtype=np.int64) + 5
    xq = _clustered(15, 6)
    if direction == "jax_to_port":
        src, dst = (dfx, catalog), (dt, pcat)
    else:
        src, dst = (dt, pcat), (dfx, catalog)
    src[0].faiss_create("a", D, f"IDMap,IVF8,{codec}", metric_type="L2",
                        catalog=src[1])
    src[0].faiss_add((ids, xb), "a", catalog=src[1])
    path = str(tmp_path / "ivfsq.dfx")
    src[0].faiss_save("a", path, catalog=src[1])
    dst[0].faiss_load("b", path, catalog=dst[1])
    params = {"nprobe": "2"}
    _assert_agree(dst[0].faiss_search("b", 5, xq, params, catalog=dst[1]),
                  src[0].faiss_search("a", 5, xq, params, catalog=src[1]))
    a, b = _inner(src[1], "a"), _inner(dst[1], "b")
    np.testing.assert_array_equal(a._codes, b._codes)
    np.testing.assert_array_equal(a._sq_scale, b._sq_scale)
    with pytest.raises(dst[0].InvalidInputError, match="immutable"):
        dst[0].faiss_add((ids, xb), "b", catalog=dst[1])


@pytest.mark.parametrize("codec", ["SQ8", "SQ4", "SQ6"])
def test_codes_byte_equal_from_the_same_rows(catalog, pcat, codec):
    """Each package trains its own centroids, but the SQ ranges come from
    the same subsample by min / max, so the ranges and the codes of the
    same rows are byte-equal; from_reference carries them as they are."""
    xb = _clustered(16, 1200, d=33)
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("own", 33, f"IVF8,{codec}", metric_type="L2",
                         catalog=cat)
        mod.faiss_add(xb, "own", catalog=cat)
    j, p = _inner(catalog, "own"), _inner(pcat, "own")
    np.testing.assert_array_equal(p._sq_vmin, j._sq_vmin)
    np.testing.assert_array_equal(p._sq_scale, j._sq_scale)
    np.testing.assert_array_equal(p._codes, j._codes)
    c = from_reference(catalog.get("own")).index
    np.testing.assert_array_equal(c._codes, j._codes)
    np.testing.assert_array_equal(c._centroids, j._centroids)
    np.testing.assert_allclose(p.reconstruct(5), j.reconstruct(5),
                               rtol=1e-6, atol=1e-6)


# --- the slice's own behaviour -----------------------------------------------

@pytest.mark.parametrize("codec", ["SQ8", "SQ4", "SQ6"])
def test_int8_path_agrees_with_decode_path(pcat, codec):
    """With the port's own training, the int8 path's exact rerank returns
    the decode path's labels and distances at full probe."""
    xb = _clustered(17, 3000)
    xq = _clustered(18, 20)
    dt.faiss_create("ivf", D, f"IVF16,{codec}", metric_type="L2",
                    catalog=pcat)
    dt.faiss_add(xb, "ivf", catalog=pcat)       # deferred train, then add
    decode = dt.faiss_search("ivf", 10, xq, {"nprobe": "16"}, catalog=pcat)
    dt.set_precision("fast")                    # "auto" → int8 in fast mode
    assert pconfig.sq_int8_active()
    int8 = dt.faiss_search("ivf", 10, xq, {"nprobe": "16"}, catalog=pcat)
    assert _inner(pcat, "ivf")._last_scan_path == "per-query"
    _assert_agree(int8, decode)


@pytest.mark.parametrize("scan", ["ivf_sq_list_search", "ivf_sq_pairs_search"])
def test_large_batch_runs_in_query_blocks(pcat, monkeypatch, scan):
    """A batch whose scan temporaries pass SCAN_BLOCK_BYTES runs in
    power-of-two query blocks through either SQ scan, with the results of
    one block."""
    xb = _clustered(19, 2000)
    xq = _clustered(20, 100)                      # padded to 128 rows
    dt.faiss_create("blk", D, "IVF4,SQ8", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "blk", catalog=pcat)
    dt.set_sq_dot("int8")
    idx = pcat.get("blk").index
    if scan == "ivf_sq_pairs_search":
        idx.PAIRS_MIN_WORK, idx.PAIRS_MIN_BATCH = 0, 1
    params = {"nprobe": "2"}
    whole = dt.faiss_search("blk", 5, xq, params, catalog=pcat)
    lmax = idx._build_device_layout().payload.shape[1]
    idx.SCAN_BLOCK_BYTES = 32 * 4 * 2 * (lmax + D)   # 32 queries a block
    blocks = []
    real = getattr(ivf_serve, scan)

    def counted(*args, **kw):
        blocks.append(args[6].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(ivf_serve, scan, counted)
    split = dt.faiss_search("blk", 5, xq, params, catalog=pcat)
    assert blocks == [32] * 4
    _assert_agree(split, whole)


def test_layout_plan_counts_code_bytes(pcat):
    """The plan budgets (nlist, lmax, w) code bytes, not d·4: a budget
    that holds the SQ8 layout exactly gives a full plan; and SQ has a plan
    only while the int8 path is active."""
    xb = _clustered(21, 1500)
    dt.faiss_create("p", D, "IVF4,SQ8", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "p", catalog=pcat)
    idx = pcat.get("p").index
    assert idx._layout_plan() is None               # parity: decode path
    dt.set_sq_dot("int8")
    full = idx._build_device_layout()
    assert full.payload.dtype.is_floating_point is False
    nlist, lmax, w = full.payload.shape
    assert w == D
    idx.LAYOUT_BUDGET_BYTES = nlist * lmax * w
    idx._invalidate()
    assert idx._layout_plan() == ("full", None)
    lay = idx._build_device_layout()
    valid = lay.row_pos >= 0
    np.testing.assert_array_equal(
        lay.rs[valid].numpy(), idx._sq_row_extras()[1][lay.row_pos[valid]])


def test_sq_dot_config_matches_jax():
    """set_sq_dot / sq_int8_active: "auto" follows the precision mode."""
    from duckdb_faiss_ext_tpu.utils import config as jcfg

    for prec in ("parity", "fast"):
        for mode in ("auto", "int8", "decode"):
            dt.set_precision(prec)
            dt.set_sq_dot(mode)
            dfx.set_precision(prec)
            dfx.set_sq_dot(mode)
            try:
                assert pconfig.sq_int8_active() == jcfg.sq_int8_active()
            finally:
                dfx.set_sq_dot("auto")
                dfx.set_precision("parity")
    with pytest.raises(ValueError, match="auto, int8, or decode"):
        dt.set_sq_dot("bf16")


def test_reconstruct_decodes(pcat):
    xb = _clustered(22, 600, d=33)
    dt.faiss_create("r", 33, "IVF4,SQ6", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "r", catalog=pcat)
    idx = pcat.get("r").index
    got = idx.reconstruct(17)
    step = idx._sq_scale
    assert got.shape == (33,)
    assert (np.abs(got - xb[17]) <= 0.5 * step + 1e-5).all()
    with pytest.raises(dt.InvalidInputError, match="out of range"):
        idx.reconstruct(600)


@pytest.mark.parametrize("factory,what", [
    ("IVF4_HNSW8,SQbf16", "IVF quantizer HNSW8"),
    ("HNSW16,SQ8", "HNSW"),
    ("PCA8,IVF4_HNSW8,SQ8", "IVF quantizer HNSW8"),
    ("IDMap,NSG16,SQ4,RFlat", "NSG")])
def test_unported_sq_forms_refused(catalog, pcat, factory, what):
    """SQ storage under the forms that waited for the graph families and
    the coarse quantizers (``what``), also behind a transform or the RFlat
    suffix: each now builds and answers as the JAX package does, with its
    trained state carried across and, where no transform is trained, from
    the port's own training with every list probed."""
    check_form_matches_jax(catalog, pcat, factory, d=8,
                           params={"nprobe": "2"},
                           own_exact=not factory.startswith("PCA"))


def test_sq_refuses_elementwise_metrics(catalog, pcat):
    """The JAX package's message for an SQ index under another metric."""
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_create("e", 8, "IVF4,SQ8", metric_type="L1",
                             catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert "support only L2 and INNER_PRODUCT" in msgs[0]
