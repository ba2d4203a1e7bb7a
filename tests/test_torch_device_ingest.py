"""The port's device-resident ingest (``faiss_train_device`` /
``faiss_add_device``, models/ivf_device.py) against the JAX package's and
against the port's own host path.

The port runs on the CPU (``config.device = "cpu"``), where its device
tensors are CPU tensors and its scans take their plain versions.  The two
packages' k-means draw different initial samples, so every case trains a
JAX index with ``faiss_train_device`` and carries the trained, empty index
into the port (``from_reference``, which also carries ``assign_topk``).
Then the same chunks are added through both packages' ``faiss_add_device``
and through the port's ``faiss_add``.

Tolerances: layouts (payload, counts, row positions, slots, Σc, the spill
rows, their lists and positions) are byte-equal; Σ(scale·c)² (rn) is an
fp32 sum whose order differs between numpy's BLAS, torch and XLA, so it
agrees to 1e-6 relative (the JAX package's own device and host paths
differ there too).  The port's device and host paths search the same
layout with the same kernels, so their results are equal; against the JAX
package, distances rtol 1e-5 with atol 1e-5·max|distance|, labels equal
wherever neighbouring distances are further apart than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.models.ivf_device import \
    capped_assign as jax_capped_assign
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.models.ivf_device import capped_assign
from duckdb_faiss_ext_tpu_torch.ops.selectors import SetSelector

METRICS = ("L2", "INNER_PRODUCT")


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


def _clustered(seed, n, d=32, ncl=16, skew=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 3
    which = rng.integers(0, ncl, n)
    if skew:
        which = np.where(rng.random(n) < skew, 0, which)
    return (centers[which]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.5)


def _trained(catalog, pcat, factory, metric, xt, names, params=None):
    """A JAX index "j" trained by faiss_train_device on xt, and a carried
    copy of it in the port under each of ``names``."""
    d = xt.shape[1]
    dfx.faiss_create_params("j", d, factory, params, metric_type=metric,
                            catalog=catalog)
    dfx.faiss_train_device(jnp.asarray(xt), "j", catalog=catalog)
    for name in names:
        pcat.put(name, from_reference(catalog.get("j")))


def _jax_payload(jdr, sq):
    """The JAX device payload as packed rows (sq6 unfolded from its
    plane-major (nlist, 3·lmax, w/3) form)."""
    p = np.asarray(jdr.payload)
    if sq != "sq6":
        return p
    nlist, l3, d4 = p.shape
    return np.ascontiguousarray(
        p.reshape(nlist, 3, l3 // 3, d4).transpose(0, 2, 3, 1)).reshape(
            nlist, l3 // 3, 3 * d4)


def _assert_dr_equal(pidx, jidx):
    """The port's device state byte-equal to the JAX package's (rn to
    rounding), before any layout build reorders the port's spill."""
    pdr, jdr = pidx._dr, jidx._dr
    assert pdr.lmax == jdr.lmax
    np.testing.assert_array_equal(pdr.payload.numpy(),
                                  _jax_payload(jdr, pidx.sq_type))
    np.testing.assert_array_equal(pdr.row_pos, jdr.row_pos)
    np.testing.assert_array_equal(pdr.counts, jdr.counts)
    np.testing.assert_array_equal(pdr.slot, jdr.slot)
    np.testing.assert_array_equal(pidx._assign, jidx._assign)
    assert pdr.spill_n == jdr.spill_n
    n = pdr.spill_n
    if n:
        np.testing.assert_array_equal(pdr.spill_payload[:n].numpy(),
                                      np.asarray(jdr.spill_payload)[:n])
        np.testing.assert_array_equal(pdr.spill_assign, jdr.spill_assign)
        np.testing.assert_array_equal(pdr.spill_pos, jdr.spill_pos)
    if pidx.sq_type is not None:
        np.testing.assert_array_equal(pdr.rs.numpy(),
                                      np.asarray(jdr.rs_layout))
        np.testing.assert_allclose(pdr.rn.numpy(), np.asarray(jdr.rn_layout),
                                   rtol=1e-6)
        if n:
            np.testing.assert_array_equal(pdr.spill_rs[:n].numpy(),
                                          jdr.spill_rs)
            np.testing.assert_allclose(pdr.spill_rn[:n].numpy(),
                                       jdr.spill_rn, rtol=1e-6)


def _assert_layouts_equal(dev, host):
    """Two indexes' padded layouts and spills, byte-equal (rn to
    rounding)."""
    a, b = dev._build_device_layout(), host._build_device_layout()
    for name in ("payload", "counts", "row_pos", "rs"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    if a.rn is not None:
        np.testing.assert_allclose(a.rn.numpy(), b.rn.numpy(), rtol=1e-6)
    sa, sb = dev._spill, host._spill
    assert (sa is None) == (sb is None)
    if sa is not None:
        assert sa.n == sb.n
        for name in ("payload", "assign", "pos", "rs"):
            x, y = getattr(sa, name), getattr(sb, name)
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), y.numpy())
        if sa.rn is not None:
            np.testing.assert_allclose(sa.rn.numpy(), sb.rn.numpy(),
                                       rtol=1e-6)
        for spill in (sa, sb):
            _assert_spill_offsets(spill, dev.nlist)
        np.testing.assert_array_equal(sa.offsets.numpy(), sb.offsets.numpy())


def _assert_spill_offsets(spill, nlist):
    """The spill is sorted by list and ``offsets`` brackets each list's
    rows: list l holds rows [offsets[l], offsets[l + 1])."""
    assign = spill.assign[:spill.n].numpy()
    assert (np.diff(assign) >= 0).all()
    off = spill.offsets.numpy()
    assert off.dtype == np.int64 and off.shape == (nlist + 1,)
    assert off[0] == 0 and off[-1] == spill.n
    for lst in range(nlist):
        assert (assign[off[lst]:off[lst + 1]] == lst).all()


def _assert_same(got, want):
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["distance"], want["distance"])


def _assert_agree(got, want):
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    scale = float(np.abs(wd[finite]).max()) if finite.any() else 1.0
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5, atol=tol)
    gap = np.abs(np.diff(np.where(finite, wd, np.inf), axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][sep], want["label"][sep])


def _int8_mode(storage):
    """The port's host path has a padded layout for SQ only on the int8
    path; a device-resident index always scans it."""
    if storage != "Flat":
        dt.set_sq_dot("int8")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage", ["SQ8", "SQ4", "SQ6", "Flat"])
def test_device_layout_byte_equal(catalog, pcat, storage, metric):
    """Two device adds (running-count slots) build the JAX package's device
    layout and the port's host-path layout byte for byte; searches equal
    the host path's and agree with the JAX package's."""
    n, nlist = 4000, 16
    xb = _clustered(3, n)
    xq = _clustered(4, 16)
    factory = f"IVF{nlist},{storage}" if storage != "Flat" else f"IVF{nlist}"
    _trained(catalog, pcat, factory, metric, xb[:1000], names=("p", "h"))
    _int8_mode(storage)
    dt.faiss_add(xb[:2500], "h", catalog=pcat)
    dt.faiss_add(xb[2500:], "h", catalog=pcat)
    host = pcat.get("h").index
    lmax = host._build_device_layout().payload.shape[1]
    dfx.faiss_add_device(jnp.asarray(xb[:2500]), "j", lmax=lmax,
                         catalog=catalog)
    dfx.faiss_add_device(jnp.asarray(xb[2500:]), "j", catalog=catalog)
    dt.faiss_add_device(torch.from_numpy(xb[:2500]), "p", lmax=lmax,
                        catalog=pcat)
    dt.faiss_add_device(xb[2500:], "p", catalog=pcat)
    dev = pcat.get("p").index
    _assert_dr_equal(dev, catalog.get("j").index)
    assert dev._layout_plan() == ("device", lmax)
    _assert_layouts_equal(dev, host)
    params = {"nprobe": "4"}
    got = dt.faiss_search("p", 5, xq, params, catalog=pcat)
    _assert_same(got, dt.faiss_search("h", 5, xq, params, catalog=pcat))
    dt.set_sq_dot("auto")
    _assert_same(dt.faiss_search("p", 5, xq, params, catalog=pcat), got)
    _assert_agree(got, dfx.faiss_search("j", 5, xq, params, catalog=catalog))


@pytest.mark.parametrize("seed,skew", [(5, 0.7), (6, 0.0)])
def test_capped_assign_matches_jax(seed, skew):
    """The numpy copy of ``capped_assign`` returns the JAX function's
    assignment and displacement count on random candidate lists."""
    rng = np.random.default_rng(seed)
    nlist, m, cap = 8, 600, 100
    top1 = np.where(rng.random(m) < skew, 0, rng.integers(0, nlist, m))
    cand = np.stack([top1] + [rng.integers(0, nlist, m) for _ in range(3)],
                    axis=1).astype(np.int32)
    counts = rng.integers(0, cap, nlist).astype(np.int64)
    counts[0] = 90
    got, got_d = capped_assign(cand, counts, cap)
    want, want_d = jax_capped_assign(cand, counts, cap)
    np.testing.assert_array_equal(got, want)
    assert got_d == want_d


def test_assign_topk_small_spill(catalog, pcat):
    """assign_topk = 4 on skewed rows, where the nearest lists would spill,
    keeps the lists within capacity (a smaller spill, under 5% as in the
    JAX package's test), byte-equal to the JAX package's device layout;
    nprobe = nlist finds every row itself."""
    n, d, nlist = 6000, 16, 16
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 4
    which = np.where(rng.random(n) < 0.5, 0, rng.integers(0, nlist, n))
    xb = centers[which] + rng.standard_normal((n, d)).astype(np.float32)
    _trained(catalog, pcat, f"IVF{nlist},SQ8", "L2", xb[:4000], ("p",),
             params={"assign_topk": "4"})
    dev = pcat.get("p").index
    assert dev.assign_topk == 4
    dfx.faiss_add_device(jnp.asarray(xb), "j", lmax=512, catalog=catalog)
    dt.faiss_add_device(xb, "p", lmax=512, catalog=pcat)
    _assert_dr_equal(dev, catalog.get("j").index)
    plain = np.bincount(dev._assign_lists(xb), minlength=nlist)
    nearest_spill = int(np.maximum(plain - 512, 0).sum())
    assert nearest_spill > 0
    assert dev._dr.spill_n < min(nearest_spill, 0.05 * n)
    res = dt.faiss_search("p", 5, xb[:32], {"nprobe": str(nlist)},
                          catalog=pcat)
    np.testing.assert_array_equal(res["label"][:, 0], np.arange(32))


def test_small_lmax_spills_with_selector(catalog, pcat):
    """A forced small lmax spills most rows: the device layout and spill
    equal the host path's capped layout (its spill put into the host's
    order), with and without a selector."""
    n, d, nlist = 3000, 16, 8
    xb = _clustered(5, n, d)
    xq = _clustered(7, 32, d)
    _trained(catalog, pcat, f"IVF{nlist},SQ8", "L2", xb[:800],
             names=("p", "h"))
    dfx.faiss_add_device(jnp.asarray(xb), "j", lmax=128, catalog=catalog)
    dt.faiss_add_device(xb, "p", lmax=128, catalog=pcat)
    dev = pcat.get("p").index
    _assert_dr_equal(dev, catalog.get("j").index)
    assert dev._dr.spill_n > n / 2
    dt.set_sq_dot("int8")
    host = pcat.get("h").index
    host.LAYOUT_BUDGET_BYTES = nlist * 128 * d
    host.SPILL_FRACTION_MAX = 0.9
    dt.faiss_add(xb, "h", catalog=pcat)
    assert host._layout_plan() == ("spill", 128)
    _assert_layouts_equal(dev, host)
    params = {"nprobe": str(nlist)}
    sel = SetSelector(np.arange(0, n, 3, dtype=np.int64))
    for s in (None, sel):
        got = dt.faiss_search("p", 6, xq, params, catalog=pcat, selector=s)
        _assert_same(got, dt.faiss_search("h", 6, xq, params, catalog=pcat,
                                          selector=s))
    assert set(np.unique(got["label"])) <= set(range(0, n, 3)) | {-1}


def test_add_device_with_ids(catalog, pcat):
    """Custom ids through faiss_add_device label the results as the host
    path's add_with_ids does."""
    n, d = 1500, 16
    xb = _clustered(11, n, d, ncl=8)
    ids = np.arange(n, dtype=np.int64) * 10 + 7
    _trained(catalog, pcat, "IVF8,SQ8", "L2", xb[:500], names=("p", "h"))
    dt.faiss_add_device(torch.from_numpy(xb), "p", ids, expected_total=n,
                        catalog=pcat)
    dt.set_sq_dot("int8")
    dt.faiss_add((ids, xb), "h", catalog=pcat)
    got = dt.faiss_search("p", 3, xb[:32], {"nprobe": "8"}, catalog=pcat)
    assert (got["label"][got["label"] >= 0] % 10 == 7).all()
    _assert_same(got, dt.faiss_search("h", 3, xb[:32], {"nprobe": "8"},
                                      catalog=pcat))
    with pytest.raises(dt.InvalidInputError, match="mix"):
        dt.faiss_add_device(xb[:4], "p", catalog=pcat)


def _raises_alike(jax_call, port_call):
    """Both packages raise InvalidInputError with the same text."""
    with pytest.raises(dfx.InvalidInputError) as want:
        jax_call()
    with pytest.raises(dt.InvalidInputError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_device_ingest_guards(catalog, pcat):
    """The add-path guards raise the JAX package's texts: sizing on the
    first add, no mixing with host adds either way, vector shapes, ids,
    PQ storage and IDMap."""
    xb = _clustered(9, 600, 8, ncl=4)
    _trained(catalog, pcat, "IVF4,SQ8", "L2", xb[:200], names=("g", "g2"))
    _raises_alike(
        lambda: dfx.faiss_add_device(jnp.asarray(xb), "j", catalog=catalog),
        lambda: dt.faiss_add_device(xb, "g", catalog=pcat))
    _raises_alike(
        lambda: dfx.faiss_add_device(jnp.asarray(xb[:, :4]), "j",
                                     expected_total=600, catalog=catalog),
        lambda: dt.faiss_add_device(xb[:, :4], "g", expected_total=600,
                                    catalog=pcat))
    _raises_alike(
        lambda: dfx.faiss_add_device(jnp.asarray(xb), "j", np.arange(5),
                                     expected_total=600, catalog=catalog),
        lambda: dt.faiss_add_device(xb, "g", np.arange(5),
                                    expected_total=600, catalog=pcat))
    dfx.faiss_add_device(jnp.asarray(xb), "j", expected_total=600,
                         catalog=catalog)
    dt.faiss_add_device(xb, "g", expected_total=600, catalog=pcat)
    _raises_alike(lambda: dfx.faiss_add(xb, "j", catalog=catalog),
                  lambda: dt.faiss_add(xb, "g", catalog=pcat))
    dt.faiss_add(xb[:100], "g2", catalog=pcat)
    dfx.faiss_create("h2", 8, "IVF4,SQ8", catalog=catalog)
    dfx.faiss_manual_train(xb[:200], "h2", catalog=catalog)
    dfx.faiss_add(xb[:100], "h2", catalog=catalog)
    _raises_alike(
        lambda: dfx.faiss_add_device(jnp.asarray(xb), "h2",
                                     expected_total=600, catalog=catalog),
        lambda: dt.faiss_add_device(xb, "g2", expected_total=600,
                                    catalog=pcat))
    for factory in ("IVF4,PQ2", "IDMap,IVF4,SQ8"):
        dfx.faiss_create("u", 8, factory, catalog=catalog)
        dt.faiss_create("u", 8, factory, catalog=pcat)
        _raises_alike(
            lambda: dfx.faiss_train_device(jnp.asarray(xb), "u",
                                           catalog=catalog),
            lambda: dt.faiss_train_device(xb, "u", catalog=pcat))
        dfx.faiss_destroy("u", catalog=catalog)
        dt.faiss_destroy("u", catalog=pcat)


@pytest.mark.parametrize("storage", ["SQ4", "SQ6", "Flat"])
def test_reconstruct_matches_jax(catalog, pcat, storage):
    """``reconstruct`` decodes through the device layout, slots and spill
    alike, as the JAX package's does."""
    n, d, nlist = 2000, 24, 8
    xb = _clustered(7, n, d, ncl=8)
    factory = f"IVF{nlist},{storage}" if storage != "Flat" else f"IVF{nlist}"
    _trained(catalog, pcat, factory, "L2", xb[:600], names=("p",))
    dfx.faiss_add_device(jnp.asarray(xb), "j", expected_total=n, lmax=128,
                         catalog=catalog)
    dt.faiss_add_device(xb, "p", expected_total=n, lmax=128, catalog=pcat)
    dev, jidx = pcat.get("p").index, catalog.get("j").index
    assert dev._dr.spill_n > 0
    keys = [0, 1, n // 2, n - 1] + list(np.nonzero(dev._dr.slot < 0)[0][:3])
    for key in keys:
        np.testing.assert_allclose(dev.reconstruct(key),
                                   jidx.reconstruct(key), rtol=1e-6,
                                   atol=1e-6)
    dev._build_device_layout()          # the spill put into host order
    for key in keys:
        np.testing.assert_allclose(dev.reconstruct(key),
                                   jidx.reconstruct(key), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("storage", ["SQ8", "Flat"])
def test_checkpoints_cross_load(catalog, pcat, tmp_path, storage):
    """A device-resident index saves in the shared format: the port's
    checkpoint loads in the JAX package and the JAX package's in the port,
    each as a host-path index searching like the device one (to fp32
    summation order: the loaded index pads its lists to its own lmax)."""
    n, d, nlist = 2000, 16, 8
    xb = _clustered(13, n, d, ncl=8)
    xq = _clustered(14, 16, d, ncl=8)
    factory = f"IVF{nlist},{storage}" if storage != "Flat" else f"IVF{nlist}"
    _trained(catalog, pcat, factory, "INNER_PRODUCT", xb[:600],
             names=("p",))
    dfx.faiss_add_device(jnp.asarray(xb), "j", lmax=256, catalog=catalog)
    dt.faiss_add_device(xb, "p", lmax=256, catalog=pcat)
    params = {"nprobe": "3"}
    mine, theirs = str(tmp_path / "p.dfx"), str(tmp_path / "j.dfx")
    dt.faiss_save("p", mine, catalog=pcat)
    dfx.faiss_save("j", theirs, catalog=catalog)
    dfx.faiss_load("from_port", mine, catalog=catalog)
    dt.faiss_load("from_jax", theirs, catalog=pcat)
    assert pcat.get("from_jax").index._dr is None
    want = dt.faiss_search("p", 5, xq, params, catalog=pcat)
    _assert_agree(dfx.faiss_search("from_port", 5, xq, params,
                                   catalog=catalog), want)
    _int8_mode(storage)
    _assert_agree(dt.faiss_search("from_jax", 5, xq, params, catalog=pcat),
                  want)


def test_search_add_search(catalog, pcat):
    """Search, add again (the spill grows, then shrinks back to its padded
    length at the next layout build), search again: every cached layout
    over the old buffers is dropped, and the results equal a host-path
    index holding the same rows."""
    n, d, nlist = 3000, 16, 8
    xb = _clustered(17, n, d, ncl=8, skew=0.5)
    xq = _clustered(18, 24, d, ncl=8)
    _trained(catalog, pcat, f"IVF{nlist},SQ8", "L2", xb[:800],
             names=("p", "h"))
    dt.set_sq_dot("int8")
    host = pcat.get("h").index
    host.LAYOUT_BUDGET_BYTES = nlist * 128 * d
    host.SPILL_FRACTION_MAX = 0.9
    params = {"nprobe": "4"}
    dt.faiss_add_device(xb[:1000], "p", lmax=128, spill_capacity=1 << 16,
                        catalog=pcat)
    dt.faiss_add(xb[:1000], "h", catalog=pcat)
    dev = pcat.get("p").index
    dev.SPILL_SLACK_BYTES = 0
    _assert_same(dt.faiss_search("p", 5, xq, params, catalog=pcat),
                 dt.faiss_search("h", 5, xq, params, catalog=pcat))
    assert dev._dr.spill_payload.shape[0] < 1 << 16     # shrunk
    dt.faiss_add_device(xb[1000:], "p", catalog=pcat)
    dt.faiss_add(xb[1000:], "h", catalog=pcat)
    assert dev._spill is None and dev._layout is None
    _assert_same(dt.faiss_search("p", 5, xq, params, catalog=pcat),
                 dt.faiss_search("h", 5, xq, params, catalog=pcat))
    _assert_layouts_equal(dev, host)


@pytest.mark.parametrize("adds", [1, 2])
def test_spill_offsets_host_and_device(catalog, pcat, adds):
    """Both layouts build their spill sorted by list with its (nlist + 1,)
    offsets, after one add and after a second one that appends spill rows
    of lists already spilled (the device spill is re-sorted at the next
    layout build)."""
    n, d, nlist = 3000, 16, 8
    xb = _clustered(19, n, d, ncl=8, skew=0.4)
    _trained(catalog, pcat, f"IVF{nlist},SQ8", "L2", xb[:800],
             names=("p", "h"))
    dt.set_sq_dot("int8")
    host = pcat.get("h").index
    host.LAYOUT_BUDGET_BYTES = nlist * 128 * d
    host.SPILL_FRACTION_MAX = 0.9
    cut = n if adds == 1 else 1700
    dt.faiss_add_device(xb[:cut], "p", lmax=128, spill_capacity=1 << 14,
                        catalog=pcat)
    dt.faiss_add(xb[:cut], "h", catalog=pcat)
    dev = pcat.get("p").index
    if adds == 2:
        dev._build_device_layout()
        dt.faiss_add_device(xb[cut:], "p", catalog=pcat)
        dt.faiss_add(xb[cut:], "h", catalog=pcat)
        assert not (np.diff(dev._dr.spill_assign) >= 0).all()
    _assert_layouts_equal(dev, host)
    assert dev._spill.n > n / 2
