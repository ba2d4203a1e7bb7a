"""The port's IMI coarse quantizer and SOAR dual assignment against the JAX
package's (the cases of tests/test_ivf.py's IMI and SOAR sections).

Parity cases train a JAX index and carry it into the port with
``from_reference`` (the materialized IMI cell table, SOAR's duplicated rows
and bookkeeping): under the same probes both packages must return the same
candidates.  Tolerance: distances rtol 1e-5, atol 1e-5 of the larger of
the batch's largest |distance| and |q|²; labels equal wherever
neighbouring distances are further apart than that.

The port's own training is held to invariants: the IMI cell table is the
cross product of two half codebooks, and its factored assignment equals the
argmin over all K² cells; SOAR's second assignment, computed on the JAX
package's centroids, agrees with the JAX package's except where the two
best costs lie within 1e-5 relative of each other (an argmin over
near-equal fp32 sums).
"""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


def _clustered(n, d, ncent=16, seed=11, spread=0.45):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncent, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, ncent, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


def assert_agree(got, want, xq):
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


def _carried(catalog, pcat, factory, xb, params=None, ids=None,
             metric="L2", name="i"):
    dfx.faiss_create_params(name, xb.shape[1], factory, params or {},
                            metric_type=metric, catalog=catalog)
    dfx.faiss_add((ids, xb) if ids is not None else xb, name,
                  catalog=catalog)
    pcat.put(name, from_reference(catalog.get(name)))


def _unique_rows(labels):
    for row in labels:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


# --- IMI -------------------------------------------------------------------

@pytest.mark.parametrize("factory,metric,nprobe", [
    ("IMI2x3,Flat", "L2", "64"), ("IMI2x3,Flat", "L2", "5"),
    ("IMI2x3,Flat", "INNER_PRODUCT", "9"), ("IMI2x2,PQ4", "L2", "16"),
    ("IMI2x2,PQ4", "L2", "3"), ("IMI2x3,SQ8", "L2", "6"),
    ("IDMap,IMI2x2,Flat", "L2", "4")])
def test_imi_matches_jax(catalog, pcat, factory, metric, nprobe):
    xb = _clustered(1000, 16)
    ids = (np.arange(1000, dtype=np.int64) * 3
           if factory.startswith("IDMap") else None)
    _carried(catalog, pcat, factory, xb, ids=ids, metric=metric)
    xq = _clustered(12, 16, seed=3)
    params = {"nprobe": nprobe}
    got = dt.faiss_search("i", 6, xq, params, catalog=pcat)
    assert_agree(got, dfx.faiss_search("i", 6, xq, params, catalog=catalog),
                 xq)


def test_imi_factored_assignment(catalog, pcat):
    """The per-half assignment equals the argmin over all K² cells of the
    table, and the JAX package's on the same table."""
    xb = _clustered(2000, 16, seed=12)
    _carried(catalog, pcat, "IMI2x3,Flat", xb)
    port = pcat.get("i").index
    table = port._centroids
    K = 8
    np.testing.assert_array_equal(table[:, :8], np.repeat(table[::K, :8], K,
                                                          0))
    np.testing.assert_array_equal(table[:, 8:], np.tile(table[:K, 8:],
                                                        (K, 1)))
    x = _clustered(700, 16, seed=13)
    got = port._assign_lists(x)
    brute = ((x[:, None, :] - table[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(
        got, catalog.get("i").index._assign_lists(x))


def test_imi_trains_below_nlist(pcat):
    """256 cells (2x4) train from 120 points: a plain IVF256 would refuse
    this corpus."""
    xb = _clustered(120, 8, ncent=8, seed=12)
    dt.faiss_create("s", 8, "IMI2x4,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "s", catalog=pcat)
    res = dt.faiss_search("s", 3, xb[:5], {"nprobe": "256"}, catalog=pcat)
    assert (res["label"][:, 0] == np.arange(5)).all()
    assert pcat.get("s").index._centroids.shape == (256, 8)


def test_imi_partial_probe_recall(pcat):
    xb = _clustered(4000, 16, ncent=32, seed=13)
    for name, desc in (("imi", "IMI2x4,Flat"), ("flat", "Flat")):
        dt.faiss_create(name, 16, desc, metric_type="L2", catalog=pcat)
        dt.faiss_add(xb, name, catalog=pcat)
    truth = dt.faiss_search("flat", 10, xb[:64], catalog=pcat)["label"]
    got = dt.faiss_search("imi", 10, xb[:64], {"nprobe": "32"},
                          catalog=pcat)["label"]
    hits = sum(len(set(g) & set(t)) for g, t in zip(got, truth))
    assert hits / truth.size > 0.8


@pytest.mark.parametrize("d,desc,metric,data", [
    (15, "IMI2x4,Flat", "L2", None), (1536, "IMI2x12,Flat", "L2", None),
    (16, "IMI2x4,Flat", "L1", None), (8, "IMI2x4,Flat", "L2", 10),
    (16, "IMI2x0,Flat", "L2", None)])
def test_imi_guards_match_jax(catalog, pcat, d, desc, metric, data):
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_create("g", d, desc, metric_type=metric, catalog=cat)
            mod.faiss_add(np.random.default_rng(0).standard_normal(
                (data, d)).astype(np.float32), "g", catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_imi_refuses_device_ingest(catalog, pcat):
    x = _clustered(300, 8, seed=14)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("d", 8, "IMI2x2,Flat", metric_type="L2",
                         catalog=cat)
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_train_device(x, "d", catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == \
        "IMIIndex does not support device-resident ingest"


# --- SOAR ------------------------------------------------------------------

@pytest.mark.parametrize("factory,nprobe,k", [
    ("IVF16,Flat", "2", 10), ("IVF16,Flat", "16", 5),
    ("IDMap,IVF16,Flat", "4", 10), ("IVF16,SQ8", "3", 10),
    ("IVF16,PQ4", "4", 8)])
def test_soar_matches_jax(catalog, pcat, factory, nprobe, k):
    xb = _clustered(1200, 16, seed=31)
    ids = (np.arange(1200, dtype=np.int64) + 100
           if factory.startswith("IDMap") else None)
    _carried(catalog, pcat, factory, xb, {"soar_lambda": "1.0"}, ids)
    port = pcat.get("i").index
    port = getattr(port, "inner", port)
    assert port.ntotal == 1200 and port._nstored == 2400
    xq = _clustered(20, 16, seed=32)
    params = {"nprobe": nprobe}
    got = dt.faiss_search("i", k, xq, params, catalog=pcat)
    assert_agree(got, dfx.faiss_search("i", k, xq, params, catalog=catalog),
                 xq)
    _unique_rows(got["label"])
    bat = dt.faiss_search_batched("i", k, xq, params, batch_size=8,
                                  catalog=pcat)
    np.testing.assert_array_equal(bat["label"], got["label"])


def test_soar_second_assignment_matches_jax(catalog, pcat):
    xb = _clustered(1500, 16, ncent=64, seed=33)
    _carried(catalog, pcat, "IVF16,Flat", xb, {"soar_lambda": "1.5"})
    jax_ix, port = catalog.get("i").index, pcat.get("i").index
    x = _clustered(600, 16, ncent=64, seed=34)
    a1 = port._assign_lists(x)
    np.testing.assert_array_equal(a1, jax_ix._assign_lists(x))
    got, want = port._assign_soar(x, a1), jax_ix._assign_soar(x, a1)
    differ = np.nonzero(got != want)[0]
    assert differ.size <= 0.01 * x.shape[0]
    c = port._centroids.astype(np.float64)
    for i in differ:
        xi = x[i].astype(np.float64)
        r = xi - c[a1[i]]
        r /= max(np.linalg.norm(r), 1e-10)
        cost = ((xi - c) ** 2).sum(1) + 1.5 * ((xi - c) @ r) ** 2
        assert abs(cost[got[i]] - cost[want[i]]) <= 1e-5 * cost[want[i]]


def test_soar_full_probe_matches_flat(pcat):
    xb = _clustered(1000, 16, ncent=8, seed=33)
    dt.faiss_create_params("s", 16, "IVF8,Flat", {"soar_lambda": "1.5"},
                           metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "s", catalog=pcat)
    dt.faiss_create("f", 16, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "f", catalog=pcat)
    a = dt.faiss_search("s", 5, xb[:8], {"nprobe": "8"}, catalog=pcat)
    b = dt.faiss_search("f", 5, xb[:8], catalog=pcat)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-4,
                               atol=1e-4)


def test_soar_improves_recall_at_fixed_nprobe(pcat):
    d = 24
    xb = _clustered(8000, d, ncent=64, seed=31)
    xq = _clustered(96, d, ncent=64, seed=32)
    dt.faiss_create("o", d, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "o", catalog=pcat)
    truth = dt.faiss_search("o", 10, xq, catalog=pcat)["label"]
    recall = []
    for name, params in (("plain", {}), ("soar", {"soar_lambda": "1.0"})):
        dt.faiss_create_params(name, d, "IVF64,Flat",
                               dict(params, train_seed="7"),
                               metric_type="L2", catalog=pcat)
        dt.faiss_add(xb, name, catalog=pcat)
        got = dt.faiss_search(name, 10, xq, {"nprobe": "4"},
                              catalog=pcat)["label"]
        recall.append(np.mean([len(set(g) & set(t)) / 10
                               for g, t in zip(got, truth)]))
    assert recall[1] > recall[0], recall


def test_soar_sequential_labels_and_reconstruct(pcat):
    """The duplicated rows stay out of the sequential label space: the
    second add's labels continue at n, ntotal counts logical rows, and
    reconstruct reads a logical row through the indirection."""
    x1 = _clustered(200, 8, ncent=4, seed=36)
    x2 = _clustered(200, 8, ncent=4, seed=37)
    dt.faiss_create_params("q", 8, "IVF4,Flat", {"soar_lambda": "1.0"},
                           metric_type="L2", catalog=pcat)
    dt.faiss_add(x1, "q", catalog=pcat)
    dt.faiss_add(x2, "q", catalog=pcat)
    ix = pcat.get("q").index
    assert ix.ntotal == 400 and ix._nstored == 800
    res = dt.faiss_search("q", 1, x2[:5], {"nprobe": "4"}, catalog=pcat)
    np.testing.assert_array_equal(res["label"][:, 0], np.arange(200, 205))
    np.testing.assert_allclose(ix.reconstruct(200), x2[0], rtol=1e-6)
    np.testing.assert_allclose(ix.reconstruct(0), x1[0], rtol=1e-6)


def test_soar_keeps_genuine_duplicate_labels(pcat):
    """Duplicates are keyed on the source row: two distinct vectors that
    share a user label both stay."""
    rng = np.random.default_rng(38)
    xb = rng.standard_normal((64, 8)).astype(np.float32) * 3
    ids = np.arange(64, dtype=np.int64)
    ids[1] = ids[0]
    dt.faiss_create_params("g", 8, "IVF4,Flat", {"soar_lambda": "1.0"},
                           metric_type="L2", catalog=pcat)
    dt.faiss_add((ids, xb), "g", catalog=pcat)
    res = dt.faiss_search("g", 64, ((xb[0] + xb[1]) / 2)[None, :],
                          {"nprobe": "4"}, catalog=pcat)
    assert (res["label"][0] == ids[0]).sum() == 2
    assert (res["label"][0] >= 0).sum() == 64


@pytest.mark.parametrize("factory", ["IDMap,IVF16,Flat", "IVF16,PQ4",
                                     "IMI2x2,Flat"])
def test_checkpoints_cross_load(catalog, pcat, tmp_path, factory):
    """SOAR's state keys and IMI's table load across both packages, in both
    directions, with equal results."""
    xb = _clustered(1200, 16, seed=34)
    idmap = factory.startswith("IDMap")
    ids = np.arange(1200, dtype=np.int64) + 100 if idmap else None
    params = {} if factory.startswith("IMI") else {"soar_lambda": "1.0"}
    dfx.faiss_create_params("j", 16, factory, params, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_add((ids, xb) if idmap else xb, "j", catalog=catalog)
    xq = xb[:12]
    sp = {"nprobe": "4"}
    want = dfx.faiss_search("j", 5, xq, sp, catalog=catalog)
    dfx.faiss_save("j", str(tmp_path / "j.dfx"), catalog=catalog)
    dt.faiss_load("p", str(tmp_path / "j.dfx"), catalog=pcat)
    got = dt.faiss_search("p", 5, xq, sp, catalog=pcat)
    assert_agree(got, want, xq)
    _unique_rows(got["label"])
    dt.faiss_save("p", str(tmp_path / "p.dfx"), catalog=pcat)
    dfx.faiss_load("j2", str(tmp_path / "p.dfx"), catalog=catalog)
    back = dfx.faiss_search("j2", 5, xq, sp, catalog=catalog)
    np.testing.assert_array_equal(back["label"], want["label"])
    np.testing.assert_array_equal(back["distance"], want["distance"])


@pytest.mark.parametrize("value,nlist", [("-1", 4), ("1.0", 1)])
def test_soar_lambda_validation_matches_jax(catalog, pcat, value, nlist):
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_create_params("v", 8, f"IVF{nlist},Flat",
                                    {"soar_lambda": value}, catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_soar_refuses_device_ingest(catalog, pcat):
    x = _clustered(300, 8, seed=15)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create_params("d", 8, "IVF4,Flat", {"soar_lambda": "1"},
                                metric_type="L2", catalog=cat)
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_train_device(x, "d", catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
