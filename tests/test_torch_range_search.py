"""The port's range search against the JAX package's.

``faiss_range_search`` through ``duckdb_faiss_ext_tpu_torch`` (on the CPU,
``config.device = "cpu"``) and through ``duckdb_faiss_ext_tpu`` on the same
trained state: a JAX index is trained and filled, then carried into the
port with ``from_reference``.  Radii are the median over the queries of
the JAX package's 10th-neighbour distance, so that about half of the
queries have at least 10 matches.

Tolerance: per query the same set of labels, leaving out rows whose
distance lies within 1e-5 of the radius's scale of it (fp32 sums in
another order may put them on either side); distances of the shared
labels within rtol 1e-5, atol 1e-5 of the query's largest |distance|.
The dense thresholding itself is held bit for bit against the JAX
package's host loop on the same tiles.
"""

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.ops import range as jax_range
from duckdb_faiss_ext_tpu.sql.dispatch import connect as jconnect
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.ops import range as port_range
from duckdb_faiss_ext_tpu_torch.sql.dispatch import connect as pconnect

TOL = 1e-5


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


def _clustered(seed, n, d, ncl=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, ncl, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.7)


def _carried(catalog, pcat, factory, metric, xb, params=None, ids=None,
             name="r"):
    dfx.faiss_create_params(name, xb.shape[1], factory, params or {},
                            metric_type=metric, catalog=catalog)
    dfx.faiss_add((ids, xb) if ids is not None else xb, name,
                  catalog=catalog)
    pcat.put(name, from_reference(catalog.get(name)))


def _radius(catalog, name, xq, params, similarity):
    d10 = dfx.faiss_search(name, 10, xq, params,
                           catalog=catalog)["distance"][:, -1]
    d10 = d10[np.isfinite(d10)]
    return float(np.median(d10)) if d10.size else (0.0 if similarity
                                                  else 1.0)


def _segments(res):
    lims = res["lims"]
    return [dict(zip(res["label"][lims[q]:lims[q + 1]].tolist(),
                     res["distance"][lims[q]:lims[q + 1]].tolist()))
            for q in range(len(lims) - 1)]


def assert_same_csr(got, want, radius):
    """Per query the same labels away from the radius, shared labels'
    distances within tolerance; returns the count of compared matches."""
    assert got["lims"].shape == want["lims"].shape
    assert got["label"].dtype == np.int64
    assert got["distance"].dtype == np.float32
    compared = 0
    for g, w in zip(_segments(got), _segments(want)):
        scale = max([abs(radius)] + [abs(v) for v in w.values()])
        near = TOL * scale

        def away(seg):
            return {lab for lab, dist in seg.items()
                    if abs(dist - radius) > near}
        assert away(g) == away(w)
        for lab in set(g) & set(w):
            assert abs(g[lab] - w[lab]) <= near + TOL * abs(w[lab])
        compared += len(away(w))
    return compared


CASES = [
    ("Flat", "L2", None), ("Flat", "INNER_PRODUCT", None),
    ("Flat", "L1", None), ("IDMap,Flat", "L2", None),
    ("SQ8", "L2", None), ("SQ4", "INNER_PRODUCT", None),
    ("SQ6", "L2", None), ("SQfp16", "L2", None), ("SQbf16", "L2", None),
    ("PQ4", "L2", None), ("PQ4", "INNER_PRODUCT", None),
    ("RQ2x4", "L2", None),
    ("IVF8,Flat", "L2", "3"), ("IVF8,Flat", "INNER_PRODUCT", "8"),
    ("IDMap,IVF8,Flat", "L2", "2"), ("IVF8,SQ8", "L2", "3"),
    ("IVF8,SQ4", "INNER_PRODUCT", "3"), ("IVF8,PQ4", "L2", "3"),
    ("IVF8,RQ2x4", "L2", "3"), ("IMI2x2,Flat", "L2", "6"),
    ("L2norm,Flat", "INNER_PRODUCT", None), ("PCA8,IVF4,Flat", "L2", "2"),
    ("PQ4,RFlat", "L2", None),
]


@pytest.mark.parametrize("factory,metric,nprobe", CASES)
def test_range_search_matches_jax(catalog, pcat, factory, metric, nprobe):
    xb = _clustered(1, 800, 16)
    ids = (np.arange(800, dtype=np.int64) * 5 + 3
           if factory.startswith("IDMap") else None)
    _carried(catalog, pcat, factory, metric, xb, ids=ids)
    params = {"nprobe": nprobe} if nprobe else None
    xq = _clustered(2, 12, 16)
    sim = metric == "INNER_PRODUCT"
    radius = _radius(catalog, "r", xq, params, sim)
    want = dfx.faiss_range_search("r", radius, xq, params, catalog=catalog)
    got = dt.faiss_range_search("r", radius, xq, params, catalog=pcat)
    assert assert_same_csr(got, want, radius) > 0


@pytest.mark.parametrize("factory,nprobe", [
    ("Flat", None), ("IDMap,Flat", None), ("IVF8,Flat", "3"),
    ("SQ8", None), ("IDMap,IVF8,PQ4", "4")])
def test_range_search_selector_matches_jax(catalog, pcat, factory, nprobe):
    """The id%2==0 selector filters labels (custom ones under IDMap, whose
    inner index sees positions) the same way in both packages."""
    xb = _clustered(3, 1000, 16)
    idmap = factory.startswith("IDMap")
    ids = np.arange(1000, dtype=np.int64) * 3 + 1 if idmap else None
    _carried(catalog, pcat, factory, "INNER_PRODUCT", xb, ids=ids)
    labels = ids if idmap else np.arange(1000, dtype=np.int64)
    even = labels[labels % 2 == 0]
    params = {"nprobe": nprobe} if nprobe else None
    xq = _clustered(4, 9, 16)
    radius = _radius(catalog, "r", xq, params, True)
    want = dfx.faiss_range_search("r", radius, xq, params, catalog=catalog,
                                  selector=dfx.SetSelector(even))
    got = dt.faiss_range_search("r", radius, xq, params, catalog=pcat,
                                selector=dt.SetSelector(even))
    assert (got["label"] % 2 == 0).all()
    assert assert_same_csr(got, want, radius) > 0


@pytest.mark.parametrize("factory", ["IVF8,Flat", "IDMap,IVF8,SQ8"])
def test_range_search_soar_matches_jax(catalog, pcat, factory):
    """SOAR's two copies of a row appear once per query segment."""
    xb = _clustered(5, 900, 16)
    ids = (np.arange(900, dtype=np.int64) + 40
           if factory.startswith("IDMap") else None)
    _carried(catalog, pcat, factory, "L2", xb, {"soar_lambda": "1.0"},
             ids=ids)
    params = {"nprobe": "3"}
    xq = xb[:10]
    radius = _radius(catalog, "r", xq, params, False)
    want = dfx.faiss_range_search("r", radius, xq, params, catalog=catalog)
    got = dt.faiss_range_search("r", radius, xq, params, catalog=pcat)
    for seg in np.split(got["label"], got["lims"][1:-1]):
        assert len(set(seg.tolist())) == len(seg)
    assert assert_same_csr(got, want, radius) > 0


def test_range_search_refused_on_lsh(catalog, pcat):
    xb = _clustered(6, 200, 16)
    _carried(catalog, pcat, "LSH", "L2", xb)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_range_search("r", 3.0, xb[:2], catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == \
        "range search is not supported for LSHIndex"


def test_range_search_empty_inputs(pcat):
    dt.faiss_create("e", 8, "IVF4,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_manual_train(_clustered(7, 200, 8), "e", catalog=pcat)
    res = dt.faiss_range_search("e", 1.0, np.zeros((3, 8), np.float32),
                                catalog=pcat)
    np.testing.assert_array_equal(res["lims"], np.zeros(4, np.int64))
    dt.faiss_create("f", 8, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(_clustered(8, 50, 8), "f", catalog=pcat)
    res = dt.faiss_range_search("f", 1.0, np.zeros((0, 8), np.float32),
                                catalog=pcat)
    assert res["lims"].tolist() == [0] and res["label"].size == 0


@pytest.mark.parametrize("metric,passing", [
    ("L2", False), ("L2", True), ("INNER_PRODUCT", True)])
def test_dense_threshold_equals_jax_loop(metric, passing):
    """The device thresholding gives the JAX package's host loop's CSR bit
    for bit on the same tiles, over chunks with a short last one."""
    rng = np.random.default_rng(9)
    nq, ntotal, chunk = 6, 1000, 256
    tiles = rng.standard_normal((nq + 2, 4 * chunk)).astype(np.float32)
    keep = rng.random(ntotal) < 0.6 if passing else None
    nchunks = -(-ntotal // chunk)
    want = jax_range.range_scan_dense(
        lambda i: tiles[:, i * chunk:(i + 1) * chunk], nchunks, chunk,
        ntotal, nq, 0.5, metric, keep)
    got = port_range.range_scan_dense(
        lambda i: torch.from_numpy(tiles[:, i * chunk:(i + 1) * chunk]),
        nchunks, chunk, ntotal, nq, 0.5, metric, keep)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sql_range_route_matches_jax(catalog, pcat):
    """SELECT faiss_range_search(...) gives one row per (query, label,
    distance) in both packages."""
    xb = _clustered(10, 600, 8)
    _carried(catalog, pcat, "Flat", "L2", xb)
    xq = xb[:4]
    rows = []
    for connect, mod, cat in ((jconnect, dfx, catalog), (pconnect, dt, pcat)):
        con = connect(catalog=cat, database=mod.Database())
        con.register("queries", {"data": xq})
        rows.append(con.execute(
            "SELECT faiss_range_search('r', 2.0, data) FROM queries"))
    want, got = rows
    assert [(r["query"], r["label"]) for r in got] == \
        [(r["query"], r["label"]) for r in want]
    np.testing.assert_allclose([r["distance"] for r in got],
                               [r["distance"] for r in want],
                               rtol=TOL, atol=TOL)
    assert {r["query"] for r in got} == {0, 1, 2, 3}


def test_range_search_refused_on_device_resident_ivf(catalog, pcat):
    """An index filled by faiss_add_device keeps no sorted layout: both
    packages refuse range search on it with the same text."""
    x = _clustered(11, 600, 16)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("d", 16, "IVF8,Flat", metric_type="L2",
                         catalog=cat)
        mod.faiss_train_device(x, "d", catalog=cat)
        mod.faiss_add_device(x, "d", catalog=cat, expected_total=600)
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_range_search("d", 1.0, x[:2], catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
