"""Selector masks built on the device (ops/selectors.py) and the native
bitmap construction (native/, ops/bitmap.py) against their plain versions and
the JAX package's.

* ``device_row_mask`` equals ``host_row_mask`` (the plain version) for
  ``BitmapSelector`` and ``SetSelector``, identity and custom labels, empty
  rows, empty selectors, and ids of 2^31 and above, where the JAX
  package's device mask truncates ids to int32 and passes wrong rows; below
  2^31 it equals the JAX package's ``device_row_mask``.  Masks are int8 and
  compared exactly.
* An IDMap wrapper's ``LabelMapSelector`` gives the same device mask as the
  host mask through its label table, ids of 2^31 and above included.
* Filtered IVF searches build their layout and spill masks on the device
  (plain IVF and IDMap,IVF, host path, device-resident index), with no
  label tested on the host, and give results equal to the host masks'.
* ``build_bitmap`` through the native library is byte-equal to the numpy
  plain version and to the JAX package's bitmap, for sequential, shuffled
  and sparse ids.
"""

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.ops import bitmap as jbitmap
from duckdb_faiss_ext_tpu.ops import selectors as jsel
from duckdb_faiss_ext_tpu_torch.native import (build_bitmap_reference,
                                               load_native)
from duckdb_faiss_ext_tpu_torch.ops import selectors as psel
from duckdb_faiss_ext_tpu_torch.ops.bitmap import build_bitmap

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


def _row_pos(n, nlist=16, lmax=64, seed=0):
    """A (nlist, lmax) layout of the storage rows 0..n-1 in shuffled order,
    -1 in the empty slots."""
    rng = np.random.default_rng(seed)
    rp = np.full(nlist * lmax, -1, np.int32)
    rp[rng.choice(nlist * lmax, n, replace=False)] = rng.permutation(n)
    return rp.reshape(nlist, lmax)


def _selectors(kind, labels, rng):
    """(port selector, JAX selector) passing about half of ``labels`` plus
    ids no row holds."""
    keep = np.concatenate([rng.choice(labels, labels.size // 2,
                                      replace=False),
                           labels.max() + 1 + rng.integers(0, 50, 20)])
    if kind == "set":
        return psel.SetSelector(keep), jsel.SetSelector(keep)
    flags = np.ones(keep.size, np.uint8)
    return build_bitmap(flags, keep), jbitmap.build_bitmap(flags, keep)


def _device_mask(sel, rp, ids):
    labels = psel.labels_for_device_mask(ids, torch.device("cpu"))
    return psel.device_row_mask(sel, torch.from_numpy(rp), labels).numpy()


@pytest.mark.parametrize("kind", ["bitmap", "set"])
@pytest.mark.parametrize("labels_kind", ["identity", "custom", "large"])
def test_device_mask_equals_host(kind, labels_kind):
    rng = np.random.default_rng(
        ["bitmap", "set"].index(kind) * 3
        + ["identity", "custom", "large"].index(labels_kind))
    n = 700
    rp = _row_pos(n)
    ids = {"identity": np.arange(n, dtype=np.int64),
           "custom": rng.permutation(n * 5)[:n].astype(np.int64),
           "large": (2**31 + rng.permutation(n * 9)[:n]).astype(np.int64)
           }[labels_kind]
    sel, _ = _selectors(kind, ids, rng)
    if labels_kind == "identity":
        assert psel.labels_for_device_mask(ids, "cpu") is None
    got = _device_mask(sel, rp, ids)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, psel.host_row_mask(sel, ids, rp))
    assert got.sum() > 0


@pytest.mark.parametrize("kind", ["bitmap", "set"])
@pytest.mark.parametrize("labels_kind", ["identity", "custom"])
def test_device_mask_equals_jax(kind, labels_kind):
    rng = np.random.default_rng(7)
    n = 600
    rp = _row_pos(n, seed=3)
    ids = (np.arange(n, dtype=np.int64) if labels_kind == "identity"
           else (rng.permutation(n * 3)[:n] * 11).astype(np.int64))
    sel, jsel_ = _selectors(kind, ids, rng)
    jlabels = jsel.labels_for_device_mask(ids)
    want = np.asarray(jsel.device_row_mask(jsel_, jnp.asarray(rp), jlabels))
    np.testing.assert_array_equal(_device_mask(sel, rp, ids), want)


def test_ids_past_int32_give_the_right_mask():
    """A SetSelector of ids 2^32 + r and 2^33 + r: no row among 0..n-1
    passes but r itself.  The JAX package's device mask truncates the ids
    to int32 and passes rows r; the port's mask equals the host mask."""
    n = 16
    rp = np.arange(n, dtype=np.int32).reshape(2, 8)
    rp[1, 5:] = -1
    keep = np.array([2**32 + 5, 3, 2**33 + 9])
    got = _device_mask(psel.SetSelector(keep), rp, np.arange(n))
    host = psel.host_row_mask(psel.SetSelector(keep), np.arange(n), rp)
    np.testing.assert_array_equal(got, host)
    assert got.sum() == 1 and got[0, 3] == 1
    jax_mask = np.asarray(jsel.device_row_mask(jsel.SetSelector(keep),
                                               jnp.asarray(rp), None))
    assert jax_mask[0, 5] == 1 and jax_mask[1, 1] == 1   # truncated ids


def test_bitmap_past_int32_bits():
    """A bitmap over ids up to 2^31 + 64 (256 MiB): the JAX package sends
    such a selector to the host; the port's device mask reads it."""
    ids = np.array([3, 2**31 + 7, 2**31 + 60], np.int64)
    sel = build_bitmap(np.ones(3, np.uint8), ids)
    assert sel.nbits == 2**31 + 61
    labels = np.array([0, 3, 2**31 + 7, 2**31 + 8, 2**31 + 60, 5], np.int64)
    rp = np.array([[0, 1, 2, 3], [4, 5, -1, 2]], np.int32)
    got = _device_mask(sel, rp, labels)
    np.testing.assert_array_equal(got, psel.host_row_mask(sel, labels, rp))
    assert got.tolist() == [[0, 1, 1, 0], [1, 0, 0, 1]]


@pytest.mark.parametrize("kind", ["bitmap", "set"])
def test_empty_selectors(kind):
    rp = _row_pos(100)
    sel = (build_bitmap(np.zeros(0, np.uint8), np.zeros(0, np.int64))
           if kind == "bitmap" else psel.SetSelector(np.zeros(0, np.int64)))
    got = _device_mask(sel, rp, np.arange(100))
    assert got.shape == rp.shape and not got.any()


def test_uploads_cached_per_selector_and_device():
    sel = psel.SetSelector(np.arange(0, 100, 3))
    rp = torch.from_numpy(_row_pos(100))
    psel.device_row_mask(sel, rp, None)
    first = sel._device_copies[torch.device("cpu")]
    psel.device_row_mask(sel, rp, None)
    assert sel._device_copies[torch.device("cpu")] is first


def test_other_selectors_are_refused():
    class Odd(psel.Selector):
        def contains(self, labels):
            return np.asarray(labels) % 2 == 1

    rp = _row_pos(50)
    with pytest.raises(TypeError, match="BitmapSelector or a SetSelector"):
        psel.device_row_mask(Odd(), torch.from_numpy(rp), None)
    mapped = psel.LabelMapSelector(Odd(), np.arange(50), lambda dev: None)
    with pytest.raises(TypeError, match="not Odd"):
        psel.device_row_mask(mapped, torch.from_numpy(rp), None)


@pytest.mark.parametrize("kind", ["bitmap", "set"])
@pytest.mark.parametrize("inner_labels", ["identity", "custom"])
def test_label_map_mask_equals_host(kind, inner_labels):
    """A selector over IDMap labels of 2^31 and above, seen from positions
    through the label table (and, for custom inner labels, from the inner
    index's own ids first): the device mask equals the host mask."""
    rng = np.random.default_rng(21 + 2 * ["bitmap", "set"].index(kind)
                                + ["identity", "custom"].index(inner_labels))
    n = 700
    rp = _row_pos(n, seed=5)
    table = (2**31 + rng.permutation(n * 6)[:n]).astype(np.int64)
    inner = (np.arange(n, dtype=np.int64) if inner_labels == "identity"
             else rng.permutation(n).astype(np.int64))
    base, _ = _selectors(kind, table, rng)
    uploads = []

    def device_table(dev):
        uploads.append(dev)
        return psel.labels_for_device_mask(table, dev)

    sel = psel.LabelMapSelector(base, table, device_table)
    got = _device_mask(sel, rp, inner)
    want = psel.host_row_mask(sel, inner, rp)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < n and uploads == [torch.device("cpu")]
    # the host version of the map: base membership of the mapped labels
    np.testing.assert_array_equal(sel.contains(inner),
                                  base.contains(table[inner]))


# --- the IVF layouts' masks --------------------------------------------------

def _host_masks(monkeypatch, ix):
    """Build every layout mask of ``ix`` through the plain host version."""
    from duckdb_faiss_ext_tpu_torch.models import ivf_layout

    def host(sel, rp, labels):
        return torch.from_numpy(psel.host_row_mask(
            sel, ix._ids, rp.cpu().numpy())).to(rp.device)

    monkeypatch.setattr(ivf_layout, "device_row_mask", host)


def _counting(monkeypatch, sel):
    """Record the masks device_row_mask builds, and fail any host
    membership test of ``sel`` meanwhile."""
    from duckdb_faiss_ext_tpu_torch.models import ivf_layout

    calls = []
    real = ivf_layout.device_row_mask

    def counted(*a):
        mask = real(*a)
        calls.append((type(a[0]).__name__, mask.shape))
        return mask

    def on_host(labels):
        raise AssertionError("selector tested on the host")

    monkeypatch.setattr(ivf_layout, "device_row_mask", counted)
    monkeypatch.setattr(sel, "contains", on_host)
    return calls


@pytest.mark.parametrize("kind", ["bitmap", "set"])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("wrap", ["IDMap,", ""])
def test_ivf_filtered_search_masks_on_device(monkeypatch, kind, spill, wrap):
    """The padded layout's (and, capped, the spill's) mask is built by
    device_row_mask, for ids of 2^31 and above held by an IDMap wrapper or
    by the IVF index itself, with no label tested on the host; results
    equal the host masks'."""
    rng = np.random.default_rng(11)
    n, d = 3000, 16
    xb = rng.standard_normal((n, d)).astype(np.float32)
    ids = (rng.permutation(n * 4)[:n] + 2**31).astype(np.int64)
    cat = dt.Catalog()
    dt.faiss_create("m", d, f"{wrap}IVF8,Flat", metric_type="L2",
                    catalog=cat)
    ix = cat.get("m").index
    ix = getattr(ix, "inner", ix)
    if spill:
        ix.LAYOUT_BUDGET_BYTES = 8 * 256 * d * 4   # lists capped at 256
        ix.SPILL_FRACTION_MAX = 0.5
        ix.UNPADDED_FLAT = False                  # and the rest spilled
    dt.faiss_add((ids, xb), "m", catalog=cat)
    keep = ids[::3]
    sel = (psel.SetSelector(keep) if kind == "set"
           else build_bitmap(np.ones(keep.size, np.uint8), keep))
    xq = xb[:10] + 0.01
    calls = _counting(monkeypatch, sel)
    got = dt.faiss_search("m", 6, xq, {"nprobe": "4"}, catalog=cat,
                          selector=sel)
    assert (ix._spill is not None) == spill
    passed = "LabelMapSelector" if wrap else type(sel).__name__
    assert [c[0] for c in calls] == [passed] * (2 if spill else 1)
    monkeypatch.undo()
    ix._invalidate()
    _host_masks(monkeypatch, ix)
    want = dt.faiss_search("m", 6, xq, {"nprobe": "4"}, catalog=cat,
                           selector=sel)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["distance"], want["distance"])
    assert np.isin(got["label"][got["label"] >= 0], keep).all()


def test_device_resident_spill_mask_on_device(monkeypatch):
    """A device-resident index's layout and spill masks from its resident
    row positions."""
    rng = np.random.default_rng(12)
    n, d = 2000, 16
    xb = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cat = dt.Catalog()
    dt.faiss_create("dr", d, "IVF4,Flat", metric_type="L2", catalog=cat)
    dt.faiss_train_device(xb, "dr", catalog=cat)
    dt.faiss_add_device(xb, "dr", catalog=cat, lmax=256)
    ix = cat.get("dr").index
    keep = np.arange(0, n, 2)
    sel = psel.SetSelector(keep)
    calls = _counting(monkeypatch, sel)
    got = dt.faiss_search("dr", 5, xb[:8].numpy(), {"nprobe": "2"},
                          catalog=cat, selector=sel)
    assert ix._spill is not None and len(calls) == 2
    monkeypatch.undo()
    ix._mask_cache.clear()
    _host_masks(monkeypatch, ix)
    want = dt.faiss_search("dr", 5, xb[:8].numpy(), {"nprobe": "2"},
                           catalog=cat, selector=sel)
    np.testing.assert_array_equal(got["label"], want["label"])
    assert (got["label"][got["label"] >= 0] % 2 == 0).all()


def test_ivf_filtered_matches_jax():
    """A filtered IVF search through the device masks against the JAX
    package's (its index carried across)."""
    from duckdb_faiss_ext_tpu_torch.io.convert import from_reference

    rng = np.random.default_rng(13)
    n, d = 2000, 16
    xb = rng.standard_normal((n, d)).astype(np.float32)
    jcat, pcat = dfx.Catalog(), dt.Catalog()
    dfx.faiss_create("j", d, "IVF8,Flat", metric_type="L2", catalog=jcat)
    dfx.faiss_add(xb, "j", catalog=jcat)
    pcat.put("j", from_reference(jcat.get("j")))
    flags = (np.arange(n) % 5 == 0).astype(np.uint8)
    xq = xb[:8] + 0.01
    want = dfx.faiss_search("j", 5, xq, {"nprobe": "8"}, catalog=jcat,
                            selector=dfx.create_mask(flags, np.arange(n)))
    got = dt.faiss_search("j", 5, xq, {"nprobe": "8"}, catalog=pcat,
                          selector=dt.create_mask(flags, np.arange(n)))
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["distance"], want["distance"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("factory,ingest", [
    ("IDMap,IVF8,Flat", "host"), ("IDMap,IVF8,SQ8", "host"),
    ("IVF8,SQ8", "device")])
def test_filter_after_add_sees_new_rows_ivf(factory, ingest):
    """A filtered IVF search, then an add of rows with new labels that pass
    the filter, then the same filtered search: the second search sees the
    new rows (no stale layout or spill mask: ``_invalidate`` drops the
    mask caches and an IDMap's ``LabelMapSelector`` keys on its label
    count) and equals the JAX package's on the same carried state.  The
    SQ8 cases run the int8 path (the padded layout and its masks); an IDMap
    wrapper has no device ingest, so that case adds labelled rows to a
    device-resident IVF,SQ8 through faiss_add_device."""
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.utils.config import config as jax_config
    from duckdb_faiss_ext_tpu_torch.io.convert import from_reference

    rng = np.random.default_rng(21)
    n, m, d = 2400, 1600, 16
    centers = rng.standard_normal((8, d)).astype(np.float32) * 4
    xb = (centers[rng.integers(0, 8, n)]
          + rng.standard_normal((n, d)).astype(np.float32) * 0.5)
    ids = np.arange(n, dtype=np.int64) * 3 + 7
    jcat, pcat = dfx.Catalog(), dt.Catalog()
    jdb, pdb = dfx.Database(), dt.Database()
    for db in (jdb, pdb):
        db.register("t", {"id": ids})
    if ingest == "host":
        dfx.faiss_create("j", d, factory, metric_type="L2", catalog=jcat)
        dfx.faiss_add((ids[:m], xb[:m]), "j", catalog=jcat)
        pcat.put("j", from_reference(jcat.get("j")))
    else:
        dfx.faiss_create("j", d, factory, metric_type="L2", catalog=jcat)
        dfx.faiss_train_device(jnp.asarray(xb[:m]), "j", catalog=jcat)
        pcat.put("j", from_reference(jcat.get("j")))
        dfx.faiss_add_device(jnp.asarray(xb[:m]), "j", ids[:m],
                             expected_total=n, catalog=jcat)
        dt.faiss_add_device(torch.from_numpy(xb[:m]), "j", ids[:m],
                            expected_total=n, catalog=pcat)
    sq = "SQ8" in factory
    # new rows whose labels pass id%2==0, each queried near itself
    new = m + np.nonzero(ids[m:] % 2 == 0)[0][:10]
    xq = xb[new] + 0.01
    params = {"nprobe": "8"}

    def search(pkg, cat, db):
        return pkg.faiss_search_filter("j", 5, xq, "id%2==0", "id", "t",
                                       params, catalog=cat, database=db)

    def jax_search():
        if not sq:
            return search(dfx, jcat, jdb)
        dfx.set_sq_dot("int8")
        dfx.set_kernel_mode("pallas")
        jax_config.spill_impl = "pallas"
        try:
            return search(dfx, jcat, jdb)
        finally:
            dfx.set_kernel_mode("auto")
            dfx.set_sq_dot("auto")
            jax_config.spill_impl = "auto"

    if sq:
        dt.set_sq_dot("int8")
    first = search(dt, pcat, pdb)
    assert not np.isin(first["label"], ids[m:]).any()
    jax_search()
    if ingest == "host":
        dfx.faiss_add((ids[m:], xb[m:]), "j", catalog=jcat)
        dt.faiss_add((ids[m:], xb[m:]), "j", catalog=pcat)
    else:
        dfx.faiss_add_device(jnp.asarray(xb[m:]), "j", ids[m:],
                             catalog=jcat)
        dt.faiss_add_device(torch.from_numpy(xb[m:]), "j", ids[m:],
                            catalog=pcat)
    inner = pcat.get("j").index
    inner = getattr(inner, "inner", inner)
    assert inner._layout_plan() is not None
    got = search(dt, pcat, pdb)
    assert (got["label"][got["label"] >= 0] % 2 == 0).all()
    np.testing.assert_array_equal(got["label"][:, 0], ids[new])
    want = jax_search()
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["distance"], want["distance"], rtol=1e-5,
                               atol=1e-5 * float(np.abs(want["distance"])
                                                 .max()))


# --- the native bitmap -------------------------------------------------------

def _ids(kind, n, rng):
    if kind == "sequential":
        return np.arange(n, dtype=np.int64)
    if kind == "shuffled":
        return rng.permutation(n).astype(np.int64)
    if kind == "offset":
        return np.arange(n, dtype=np.int64) + 5       # no 8-aligned runs
    return np.sort(rng.choice(n * 7, n, replace=False)).astype(np.int64)


@pytest.mark.parametrize("kind", ["sequential", "shuffled", "offset",
                                  "sparse"])
@pytest.mark.parametrize("n", [1, 8, 13, 1000, 65_537])
def test_native_bitmap_byte_equal(kind, n):
    rng = np.random.default_rng(n)
    ids = _ids(kind, n, rng)
    flags = (rng.random(n) < 0.5).astype(np.uint8)
    sel = build_bitmap(flags, ids)
    nbytes = (int(ids.max()) + 8) // 8
    assert sel.nbits == int(ids.max()) + 1
    np.testing.assert_array_equal(sel.bitmap,
                                  build_bitmap_reference(flags, ids, nbytes))
    np.testing.assert_array_equal(sel.bitmap,
                                  load_native().build_bitmap(flags, ids,
                                                             nbytes))
    want = jbitmap.build_bitmap(flags, ids)
    assert want.nbits == sel.nbits
    np.testing.assert_array_equal(sel.bitmap, want.bitmap)


def test_bitmap_rejects_negative_ids():
    with pytest.raises(ValueError, match="non-negative"):
        build_bitmap(np.ones(2, np.uint8), np.array([3, -1]))
