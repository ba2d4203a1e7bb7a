"""The port's RFlat refine wrapper and LSH index against the JAX package's.

RFlat: a JAX ``...,RFlat`` index is trained and filled and carried into the
port (``from_reference``: the base's state and the raw rows); both rerank
the base's k_base = min(max(k, round(k·k_factor)), ntotal) candidates in
fp32.  Tolerance: labels equal wherever neighbouring distances are apart,
distances within rtol 1e-6 / atol 1e-6 of the query's scale (the same fp32
difference-form sum, reduced in another order), and equal to a float64
oracle of the returned rows to 1e-5.

LSH: codes are encoded on the host in numpy in both packages (bit-equal),
scored by an exact int32 dot: Hamming distances must be equal exactly, to
the JAX package's and to a numpy bit count; labels are compared tie-aware
(a tie group at the k-th distance may be filled in any order).
"""

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.ops.flat_search import pm1_dots


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


def _gauss(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _carried(catalog, pcat, factory, metric, xb, ids=None, name="x"):
    dfx.faiss_create(name, xb.shape[1], factory, metric_type=metric,
                     catalog=catalog)
    dfx.faiss_add((ids, xb) if ids is not None else xb, name,
                  catalog=catalog)
    pcat.put(name, from_reference(catalog.get(name)))


def _oracle(xq, xb, metric):
    q, b = xq.astype(np.float64), xb.astype(np.float64)
    if metric == "L2":
        return ((q[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return q @ b.T


# --- RFlat ---------------------------------------------------------------------

RFLAT = [
    ("PQ4,RFlat", "L2", {"k_factor": "40"}),
    ("PQ4,RFlat", "INNER_PRODUCT", {"k_factor": "8"}),
    ("IVF8,PQ4,RFlat", "L2", {"nprobe": "8", "k_factor": "8"}),
    ("IDMap,IVF16,SQ8,RFlat", "L2", {"nprobe": "4", "k_factor": "4"}),
    ("SQ4,RFlat", "INNER_PRODUCT", {"k_factor": "3"}),
    ("OPQ4,IVF8,PQ4,RFlat", "L2", {"nprobe": "4", "k_factor": "8"}),
    ("IMI2x2,PQ8,RFlat", "L2", {"nprobe": "8", "k_factor": "2.5"}),
    ("Flat,RFlat", "L1", None),
]


@pytest.mark.parametrize("factory,metric,params", RFLAT)
def test_rflat_matches_jax(catalog, pcat, factory, metric, params):
    xb = _gauss(1, 1200, 16)
    ids = (np.arange(1200, dtype=np.int64) * 3 + 5
           if factory.startswith("IDMap") else None)
    _carried(catalog, pcat, factory, metric, xb, ids)
    xq = _gauss(2, 12, 16)
    want = dfx.faiss_search("x", 5, xq, params, catalog=catalog)
    got = dt.faiss_search("x", 5, xq, params, catalog=pcat)
    wd, gd = want["distance"], got["distance"]
    tol = 1e-6 * np.abs(wd).max(1, keepdims=True)
    assert (np.abs(gd - wd) <= tol + 1e-6 * np.abs(wd)).all()
    gap = np.abs(np.diff(wd, axis=1)) > 2 * tol
    apart = np.ones_like(gap[:, :1]).repeat(5, 1)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][apart], want["label"][apart])
    if metric in ("L2", "INNER_PRODUCT"):
        pos = (got["label"] - 5) // 3 if ids is not None else got["label"]
        exact = np.take_along_axis(_oracle(xq, xb, metric), pos, 1)
        np.testing.assert_allclose(gd, exact, rtol=1e-5, atol=1e-5)
    bat = dt.faiss_search_batched("x", 5, xq, params, batch_size=4,
                                  catalog=pcat)
    np.testing.assert_array_equal(bat["label"], got["label"])
    np.testing.assert_array_equal(bat["distance"], got["distance"])


def test_rflat_k_base_and_padding(catalog, pcat):
    """k_base = min(max(k, round(k·k_factor)), ntotal): a k above ntotal
    pads with -1 and the sentinel; a k_factor below 1 is refused with the
    JAX package's text."""
    xb = _gauss(3, 300, 8)
    _carried(catalog, pcat, "PQ2,RFlat", "L2", xb)
    calls = []
    base = pcat.get("x").index.base
    orig = base.search

    def spy(xq, k, *a):
        calls.append(k)
        return orig(xq, k, *a)

    base.search = spy
    dt.faiss_search("x", 7, xb[:2], {"k_factor": "2.6"}, catalog=pcat)
    assert calls == [18]
    res = dt.faiss_search("x", 320, xb[:2], {"k_factor": "4"}, catalog=pcat)
    assert calls[-1] == 300
    assert (res["label"][:, 300:] == -1).all()
    assert np.isinf(res["distance"][:, 300:]).all()
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_search("x", 3, xb[:1], {"k_factor": "0.5"},
                             catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "k_factor must be >= 1 (got 0.5)"


def test_rflat_selector_matches_jax(catalog, pcat):
    xb = _gauss(4, 1500, 16)
    ids = np.arange(1500, dtype=np.int64) + 11
    _carried(catalog, pcat, "IDMap,PQ4,RFlat", "L2", xb, ids)
    even = ids[ids % 2 == 0]
    xq = _gauss(5, 6, 16)
    params = {"k_factor": "10"}
    jres = catalog.get("x").index.search(xq, 5, dfx.ParamMap(params),
                                         dfx.SetSelector(even))
    pres = pcat.get("x").index.search(xq, 5, dt.ParamMap(params),
                                      dt.SetSelector(even))
    np.testing.assert_array_equal(pres.labels, jres.labels)
    np.testing.assert_allclose(pres.distances, jres.distances, rtol=1e-6,
                               atol=1e-6)
    assert (pres.labels % 2 == 0).all()


@pytest.mark.parametrize("factory", ["PQ4,RFlat", "IDMap,IVF8,SQ8,RFlat",
                                     "LSHrt", "IDMap,LSH"])
def test_checkpoints_cross_load(catalog, pcat, tmp_path, factory):
    xb = _gauss(6, 1200, 16)
    idmap = factory.startswith("IDMap")
    ids = np.arange(1200, dtype=np.int64) * 2 if idmap else None
    data = (ids, xb) if idmap else xb
    params = ({"nprobe": "8", "k_factor": "4"} if "IVF" in factory
              else {"k_factor": "4"} if "RFlat" in factory else None)
    xq = _gauss(7, 8, 16)
    dfx.faiss_create("j", 16, factory, metric_type="L2", catalog=catalog)
    dfx.faiss_add(data, "j", catalog=catalog)
    want = dfx.faiss_search("j", 5, xq, params, catalog=catalog)
    dfx.faiss_save("j", str(tmp_path / "j.dfx"), catalog=catalog)
    dt.faiss_load("p", str(tmp_path / "j.dfx"), catalog=pcat)
    got = dt.faiss_search("p", 5, xq, params, catalog=pcat)
    np.testing.assert_allclose(got["distance"], want["distance"], rtol=1e-6,
                               atol=1e-6)
    if "LSH" not in factory:
        np.testing.assert_array_equal(got["label"], want["label"])
    dt.faiss_save("p", str(tmp_path / "p.dfx"), catalog=pcat)
    dfx.faiss_load("j2", str(tmp_path / "p.dfx"), catalog=catalog)
    back = dfx.faiss_search("j2", 5, xq, params, catalog=catalog)
    np.testing.assert_array_equal(back["label"], want["label"])
    np.testing.assert_array_equal(back["distance"], want["distance"])


# --- LSH -----------------------------------------------------------------------

def _hamming(index, xb, xq):
    cb = index.encode(xb) > 0
    cq = index.encode(xq) > 0
    return (cq[:, None, :] != cb[None, :, :]).sum(-1).astype(np.float32)


def assert_tie_aware(got_d, got_l, want_d, ham):
    """Distances equal exactly; every label achieves its distance; below
    each query's k-th distance the label sets are equal."""
    np.testing.assert_array_equal(got_d, want_d)
    live = got_l >= 0
    achieved = np.take_along_axis(ham, np.where(live, got_l, 0), 1)
    np.testing.assert_array_equal(np.where(live, achieved, np.inf),
                                  np.where(live, got_d, np.inf))
    for q in range(got_d.shape[0]):
        kth = want_d[q, -1]
        assert set(got_l[q][got_d[q] < kth]) == \
            set(np.nonzero(ham[q] < kth)[0])
        assert len(set(got_l[q][live[q]])) == live[q].sum()


@pytest.mark.parametrize("desc,nbits", [
    ("LSH", 16), ("LSHr", 16), ("LSH24r", 24), ("LSH8", 8), ("LSHrt", 16),
    ("LSH64", 64), ("ITQ,LSH16", 16), ("ITQ8,LSH", 8)])
def test_lsh_matches_jax(catalog, pcat, desc, nbits):
    xb = _gauss(11, 600, 16)
    xq = _gauss(12, 9, 16)
    _carried(catalog, pcat, desc, "INNER_PRODUCT", xb)
    lsh = pcat.get("x").index
    lsh = getattr(lsh, "inner", lsh)
    assert lsh.nbits == nbits and lsh.metric.name == "L2"
    jl = catalog.get("x").index
    jl = getattr(jl, "inner", jl)
    xt = (pcat.get("x").index.apply_chain(xq) if desc.startswith("ITQ")
          else xq)
    np.testing.assert_array_equal(lsh.encode(xt), jl._encode(xt))
    want = dfx.faiss_search("x", 7, xq, catalog=catalog)
    got = dt.faiss_search("x", 7, xq, catalog=pcat)
    xbt = (pcat.get("x").index.apply_chain(xb) if desc.startswith("ITQ")
           else xb)
    assert_tie_aware(got["distance"], got["label"], want["distance"],
                     _hamming(lsh, xbt, xt))


def test_lsh_trained_thresholds(pcat):
    """LSHt requires training; its thresholds split offset data whose
    untrained codes would all be equal."""
    xb = (_gauss(3, 400, 16) + 5.0).astype(np.float32)
    dt.faiss_create("lt", 16, "LSHt", metric_type="L2", catalog=pcat)
    idx = pcat.get("lt").index
    assert idx.requires_training and not idx.is_trained
    with pytest.raises(dt.InvalidInputError, match="not trained"):
        idx.add(xb)
    dt.faiss_add(xb, "lt", catalog=pcat)
    assert idx.is_trained
    assert dt.faiss_search("lt", 5, xb[:4],
                           catalog=pcat)["distance"].max() > 0
    dt.faiss_create("lu", 16, "LSH", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "lu", catalog=pcat)
    assert dt.faiss_search("lu", 5, xb[:4],
                           catalog=pcat)["distance"].max() == 0


def test_lsh_selector_idmap_batched(catalog, pcat):
    xb = _gauss(5, 300, 16)
    ids = np.arange(300, dtype=np.int64) * 10
    _carried(catalog, pcat, "IDMap,LSH", "L2", xb, ids)
    res = dt.faiss_search("x", 4, xb[:6], catalog=pcat)
    assert (res["label"] % 10 == 0).all()
    assert (res["distance"][:, 0] == 0).all()
    bat = dt.faiss_search_batched("x", 4, xb[:6], batch_size=2,
                                  catalog=pcat)
    np.testing.assert_array_equal(res["label"], bat["label"])
    np.testing.assert_array_equal(res["distance"], bat["distance"])
    keep = ids[ids % 20 == 0]
    want = catalog.get("x").index.search(xb[:6], 4, None,
                                         dfx.SetSelector(keep))
    got = pcat.get("x").index.search(xb[:6], 4, None, dt.SetSelector(keep))
    np.testing.assert_array_equal(got.distances, want.distances)
    assert np.isin(got.labels, keep).all()


def test_lsh_k_above_ntotal(pcat):
    xb = _gauss(9, 3, 16)
    dt.faiss_create("lk", 16, "LSH", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "lk", catalog=pcat)
    res = dt.faiss_search("lk", 8, xb[:2], catalog=pcat)
    assert res["label"].shape == (2, 8)
    assert (res["label"][:, 3:] == -1).all()
    assert np.isinf(res["distance"][:, 3:]).all()


@pytest.mark.parametrize("m,n,d", [(1, 5, 7), (40, 33, 64), (3, 1, 130)])
def test_pm1_dots_exact(m, n, d):
    g = np.random.default_rng(m * n + d)
    a = np.where(g.random((m, d)) < 0.5, -1, 1).astype(np.int8)
    b = np.where(g.random((n, d)) < 0.5, -1, 1).astype(np.int8)
    got = pm1_dots(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)
