"""The port's standalone SQ indexes and float SQ codecs against the JAX
package.

``SQ8`` / ``SQ4`` / ``SQ6`` / ``SQfp16`` / ``SQbf16`` (with IDMap) through
``duckdb_faiss_ext_tpu_torch`` (on the CPU: ``config.device = "cpu"``) and
through ``duckdb_faiss_ext_tpu``, from the same seeded numpy rows: search
in parity mode (both packages' fp32 decode scans) and in fast mode (the
int8 digit-dot scans with their fp32 rerank for the quantized codecs),
with and without a selector, adds after a search, ``reconstruct``, the
non-power-of-two capacity tail, checkpoints both ways, the codes
byte-equal (the float codecs' bf16 / fp16 bytes included), ``IVFn,SQfp16``
/ ``SQbf16`` carried by ``from_reference`` (they search through the
sorted+gather decode scan, never the int8 kernels), and the factory
strings of tests/test_property.py that now build.

Tolerance: distances rtol=1e-5, atol=1e-5 times the larger of the largest
|distance| and the largest ‖q‖² (fp32 sums in another order: the decode
scans take L2 in expansion form); labels equal wherever the neighbouring
distances are further apart than that.  The parity decode path is not
bit-exact against the JAX package's (the two fp32 matmuls sum in other
orders), so it is held to the same tolerance.  The SQ ranges and every
code are bit-equal: min / max, one fp32 division and round-half-even.

The int8 scan's card case (``torch._int_mm`` on card tensors) is in
tests/test_torch_package.py, which runs on the card without JAX.
"""

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.ops.selectors import BitmapSelector as JaxBitmap
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.ops import sq as psq
from duckdb_faiss_ext_tpu_torch.ops.selectors import BitmapSelector

D = 32
CODECS = ["SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16"]


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev
    dt.set_precision("parity")
    dfx.set_precision("parity")


@pytest.fixture
def pcat():
    return dt.Catalog()


def _clustered(seed, n, d=D, ncl=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, ncl, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.4)


def _assert_agree(got, want, xq):
    np.testing.assert_array_equal(got["rank"], want["rank"])
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    np.testing.assert_array_equal(got["label"][~finite],
                                  want["label"][~finite])
    scale = max(float(np.abs(wd[finite]).max()) if finite.any() else 1.0,
                float((xq * xq).sum(1).max()))
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5, atol=tol)
    signed = np.where(finite, wd, np.inf)
    gap = np.abs(np.diff(signed, axis=1)) > 2 * tol
    separated = finite.copy()
    separated[:, 1:] &= gap
    separated[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][separated],
                                  want["label"][separated])


def _both(catalog, pcat, factory, metric, data, name="s"):
    """Create and fill ``factory`` in both packages from the same rows."""
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create(name, D, factory, metric_type=metric, catalog=cat)
        mod.faiss_add(data, name, catalog=cat)


def _search_both(catalog, pcat, name, k, xq, mode="parity", **kw):
    out = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.set_precision(mode)
        try:
            out.append(mod.faiss_search(name, k, xq, catalog=cat, **kw))
        finally:
            mod.set_precision("parity")
    return out


def _inner(cat, name):
    index = cat.get(name).index
    return getattr(index, "inner", index)


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", CODECS)
def test_search_matches_jax(catalog, pcat, codec, metric, mode):
    xb = _clustered(1, 3000)
    xq = _clustered(2, 20)
    _both(catalog, pcat, codec, metric, xb)
    want, got = _search_both(catalog, pcat, "s", 10, xq, mode)
    _assert_agree(got, want, xq)


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("codec", CODECS)
def test_selector_matches_jax(catalog, pcat, codec, mode):
    xb = _clustered(3, 2000)
    xq = _clustered(4, 12)
    ids = np.arange(2000, dtype=np.int64) * 3 + 1
    _both(catalog, pcat, f"IDMap,{codec}", "L2", (ids, xb))
    flags = np.zeros(ids.max() + 1, bool)
    flags[ids[::3]] = True
    want = _search_both(catalog, pcat, "s", 10, xq, mode,
                        selector=JaxBitmap.from_bool(flags))[0]
    dt.set_precision(mode)
    got = dt.faiss_search("s", 10, xq, catalog=pcat,
                          selector=BitmapSelector.from_bool(flags))
    _assert_agree(got, want, xq)
    assert flags[got["label"][got["label"] >= 0]].all()


@pytest.mark.parametrize("codec", CODECS)
def test_filtered_search_matches_jax(catalog, pcat, codec):
    xb = _clustered(5, 1500)
    xq = _clustered(6, 8)
    ids = np.arange(1500, dtype=np.int64)
    _both(catalog, pcat, f"IDMap,{codec}", "INNER_PRODUCT", (ids, xb))
    out = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        db = mod.Database()
        db.register("t", {"id": ids})
        out.append(mod.faiss_search_filter("s", 5, xq, "id%4==1", "id", "t",
                                           catalog=cat, database=db))
    _assert_agree(out[1], out[0], xq)
    assert (out[1]["label"] % 4 == 1).all()


@pytest.mark.parametrize("codec", CODECS)
def test_add_after_search(catalog, pcat, codec):
    xb = _clustered(7, 2400)
    xq = _clustered(8, 10)
    _both(catalog, pcat, codec, "L2", xb[:1000])
    for mode in ("parity", "fast"):
        _search_both(catalog, pcat, "s", 5, xq, mode)
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_add(xb[1000:], "s", catalog=cat)
    for mode in ("parity", "fast"):
        want, got = _search_both(catalog, pcat, "s", 5, xq, mode)
        _assert_agree(got, want, xq)
    assert _inner(pcat, "s").ntotal == 2400


@pytest.mark.parametrize("codec", CODECS)
def test_reconstruct_matches_jax(catalog, pcat, codec):
    xb = _clustered(9, 500)
    _both(catalog, pcat, codec, "L2", xb)
    j, p = _inner(catalog, "s"), _inner(pcat, "s")
    for key in (0, 17, 499):
        np.testing.assert_allclose(p.reconstruct(key), j.reconstruct(key),
                                   rtol=1e-6, atol=1e-6)
    if codec in ("SQfp16", "SQbf16"):
        np.testing.assert_array_equal(p.reconstruct(3),
                                      np.asarray(j.reconstruct(3)))


@pytest.mark.parametrize("codec", CODECS)
def test_codes_byte_equal_from_the_same_rows(catalog, pcat, codec):
    """Codes, ranges and the checkpoint's float bytes are the JAX
    package's, bit for bit."""
    xb = _clustered(10, 777)
    _both(catalog, pcat, codec, "L2", xb)
    js, ps = _inner(catalog, "s").state_dict(), _inner(pcat, "s").state_dict()
    assert sorted(js) == sorted(ps)
    for key in js:
        np.testing.assert_array_equal(np.asarray(ps[key]),
                                      np.asarray(js[key]))
        assert np.asarray(ps[key]).dtype == np.asarray(js[key]).dtype


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("codec", CODECS)
def test_checkpoint_cross_load(catalog, pcat, tmp_path, codec, direction):
    xb = _clustered(11, 900)
    xq = _clustered(12, 9)
    path = str(tmp_path / "sq.dfx")
    src, dst = ((dfx, catalog), (dt, pcat))
    if direction == "port_to_jax":
        src, dst = dst, src
    src[0].faiss_create("a", D, f"IDMap,{codec}", metric_type="L2",
                        catalog=src[1])
    src[0].faiss_add((np.arange(900) + 5, xb), "a", catalog=src[1])
    src[0].faiss_save("a", path, catalog=src[1])
    dst[0].faiss_load("b", path, catalog=dst[1])
    want = src[0].faiss_search("a", 7, xq, catalog=src[1])
    got = dst[0].faiss_search("b", 7, xq, catalog=dst[1])
    _assert_agree(got, want, xq)
    np.testing.assert_array_equal(_inner(dst[1], "b").state_dict()["codes"],
                                  _inner(src[1], "a").state_dict()["codes"])


def test_int8_path_matches_parity_labels(pcat, tmp_path):
    """SQ8's int8 scan gives the parity decode path's labels on clustered
    data wherever the distances are apart (tests/test_review_regressions.py
    ::test_sq8_int8_scan_path asks for every label, which a near-tie of
    query 9 at 1.5e-5 relative, under the decode path's expansion-form
    rounding, does not give here); a selector is honoured and the labels
    survive save / load."""
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((32, 48)).astype(np.float32) * 3
    xb = (centers[rng.integers(0, 32, 5000)]
          + rng.standard_normal((5000, 48)).astype(np.float32) * 0.3)
    xq = xb[:32]
    dt.faiss_create("sq8i", 48, "SQ8", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "sq8i", catalog=pcat)
    ref = dt.faiss_search("sq8i", 10, xq, catalog=pcat)
    flags = np.zeros(5000, bool)
    flags[::2] = True
    dt.set_precision("fast")
    assert _inner(pcat, "sq8i").int8_serves()
    fast = dt.faiss_search("sq8i", 10, xq, catalog=pcat)
    fsel = dt.faiss_search("sq8i", 10, xq, catalog=pcat,
                           selector=BitmapSelector.from_bool(flags))
    p = str(tmp_path / "sq8i.dfx")
    dt.faiss_save("sq8i", p, catalog=pcat)
    dt.faiss_load("sq8i2", p, catalog=pcat)
    reload = dt.faiss_search("sq8i2", 10, xq, catalog=pcat)
    _assert_agree(fast, ref, xq)
    assert flags[fsel["label"][fsel["label"] >= 0]].all()
    np.testing.assert_array_equal(fast["label"], reload["label"])


@pytest.mark.parametrize("codec", ["SQ8", "SQ4", "SQ6"])
def test_int8_gate(pcat, codec):
    """The int8 scan serves a quantized codec under L2 / inner product at
    d ≥ 16 while the int8 path is active, as in the JAX package."""
    for d, metric, want in ((16, "L2", True), (15, "L2", False),
                            (16, "INNER_PRODUCT", True), (16, "L1", False)):
        name = f"{codec}{d}{metric}"
        dt.faiss_create(name, d, codec, metric_type=metric, catalog=pcat)
        dt.faiss_add(_clustered(13, 200, d), name, catalog=pcat)
        index = _inner(pcat, name)
        assert not index.int8_serves()
        dt.set_sq_dot("int8")
        try:
            assert index.int8_serves() == want
        finally:
            dt.set_sq_dot("auto")


def test_float_codecs_never_take_the_int8_scan(pcat, monkeypatch):
    from duckdb_faiss_ext_tpu_torch.models import sq as msq

    def refuse(*args, **kw):
        raise AssertionError("the int8 scan ran")

    monkeypatch.setattr(msq, "sq_int8_search", refuse)
    dt.set_precision("fast")
    for codec in ("SQfp16", "SQbf16"):
        dt.faiss_create(codec, D, codec, catalog=pcat)
        dt.faiss_add(_clustered(14, 300), codec, catalog=pcat)
        assert not _inner(pcat, codec).int8_serves()
        dt.faiss_search(codec, 3, _clustered(15, 2), catalog=pcat)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_scan_covers_nonpow2_capacity_tail(pcat, mode):
    """Capacities above 2^20 rows grow in 1M-row steps (not powers of two);
    queries drawn from the tail find themselves on the decode and the
    int8 paths (tests/test_review_regressions.py::
    test_sq_scan_covers_nonpow2_capacity_tail, here at d = 16 so that fast
    mode takes the int8 scan)."""
    n, d = 2_100_000, 16
    xb = np.random.default_rng(13).standard_normal((n, d)).astype(np.float32)
    dt.faiss_create("sqt", d, "SQ8", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "sqt", catalog=pcat)
    index = _inner(pcat, "sqt")
    cap = index._capacity()
    assert cap & (cap - 1) != 0 and cap > n
    dt.set_precision(mode)
    assert index.int8_serves() == (mode == "fast")
    res = dt.faiss_search("sqt", 1, xb[n - 16:], catalog=pcat)
    assert (res["label"][:, 0] == np.arange(n - 16, n)).mean() > 0.9
    assert (res["label"][:, 0] >= 1 << 21).all()


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["SQfp16", "SQbf16"])
def test_ivf_float_codec_from_reference(catalog, pcat, codec, metric):
    """A JAX-trained IVF4,SQfp16 / SQbf16 carried by from_reference: no
    layout plan in either precision mode, the sorted+gather decode scan,
    results as the JAX package's."""
    xb = _clustered(16, 2000)
    xq = _clustered(17, 16)
    dfx.faiss_create("src", D, f"IDMap,IVF8,{codec}", metric_type=metric,
                     catalog=catalog)
    dfx.faiss_add((np.arange(2000) + 3, xb), "src", catalog=catalog)
    pcat.put("src", from_reference(catalog.get("src")))
    index = _inner(pcat, "src")
    np.testing.assert_array_equal(index.state_dict()["codes"],
                                  _inner(catalog, "src").state_dict()["codes"])
    for mode in ("parity", "fast"):
        for mod in (dfx, dt):
            mod.set_precision(mode)
        try:
            want = dfx.faiss_search("src", 10, xq, {"nprobe": "3"},
                                    catalog=catalog)
            got = dt.faiss_search("src", 10, xq, {"nprobe": "3"},
                                  catalog=pcat)
            assert index._layout_plan() is None
            assert index._last_scan_path == "gather"
        finally:
            for mod in (dfx, dt):
                mod.set_precision("parity")
        _assert_agree(got, want, xq)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("codec", ["SQfp16", "SQbf16"])
def test_ivf_float_codec_checkpoint_cross_load(catalog, pcat, tmp_path,
                                               codec, direction):
    xb = _clustered(18, 1200)
    xq = _clustered(19, 8)
    dfx.faiss_create("a", D, f"IVF4,{codec}", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "a", catalog=catalog)
    pcat.put("a", from_reference(catalog.get("a")))
    path = str(tmp_path / "ivf.dfx")
    src, dst = ((dfx, catalog), (dt, pcat))
    if direction == "port_to_jax":
        src, dst = dst, src
    src[0].faiss_save("a", path, catalog=src[1])
    dst[0].faiss_load("b", path, catalog=dst[1])
    want = src[0].faiss_search("a", 5, xq, {"nprobe": "4"}, catalog=src[1])
    got = dst[0].faiss_search("b", 5, xq, {"nprobe": "4"}, catalog=dst[1])
    _assert_agree(got, want, xq)


@pytest.mark.parametrize("codec", ["SQfp16", "SQbf16"])
def test_ivf_float_codec_refuses_device_ingest(catalog, pcat, codec):
    """Device-resident ingest refuses the float codecs with the JAX
    package's message."""
    xb = _clustered(20, 300)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("e", D, f"IVF4,{codec}", metric_type="L2",
                         catalog=cat)
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_train_device(xb, "e", catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert f"not SQ codec {codec[2:]}" in msgs[0]


# tests/test_property.py::test_save_load_roundtrip_all_factories: the SQ
# strings of its list that the port builds now
@pytest.mark.parametrize("desc", ["SQ8", "SQfp16", "SQ4", "SQ6", "IVF4,SQ8",
                                  "IVF4,SQ4", "IVF4,SQfp16", "SQbf16",
                                  "IVF4,SQbf16"])
def test_property_factories_build_and_roundtrip(pcat, tmp_path, desc):
    rng = np.random.default_rng(7)
    d, n = 16, 600
    xb = rng.random((n, d)).astype(np.float32)
    dt.faiss_create("rt", d, desc, metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "rt", catalog=pcat)
    path = str(tmp_path / "rt.dfx")
    dt.faiss_save("rt", path, catalog=pcat)
    dt.faiss_load("rt2", path, catalog=pcat)
    params = {"nprobe": "4"} if desc.startswith("IVF") else None
    a = dt.faiss_search("rt", 5, xb[:10], params, catalog=pcat)
    b = dt.faiss_search("rt2", 5, xb[:10], params, catalog=pcat)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_array_equal(a["distance"], b["distance"])


def test_range_search_not_yet_available(pcat):
    dt.faiss_create("r", D, "SQ8", catalog=pcat)
    dt.faiss_add(_clustered(21, 100), "r", catalog=pcat)
    with pytest.raises(dt.InvalidInputError,
                       match="range search is not yet available in "
                             "duckdb_faiss_ext_tpu_torch"):
        _inner(pcat, "r").range_search(_clustered(22, 2), 1.0)


def test_int8_dots_are_exact():
    """The int8 scan's dots equal int64 products, for every codec and odd
    widths (the zero padding to whole multiples of 8 adds nothing)."""
    g = torch.Generator().manual_seed(5)
    for codec, d in (("sq8", 33), ("sq4", 17), ("sq6", 21)):
        a = torch.randint(-127, 128, (5, d), generator=g, dtype=torch.int8)
        q = torch.randint(0, psq.SQ_LEVELS[codec] + 1, (29, d), generator=g,
                          dtype=torch.uint8)
        codes = torch.from_numpy(psq.sq_pack(q.numpy(), codec))
        want = a.long() @ (q.long() - psq.SQ_INT8_SHIFT[codec]).T
        assert torch.equal(psq.int8_dots(a, codes, d, codec).long(), want)
