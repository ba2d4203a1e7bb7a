"""The port's PQ / RQ slice end to end against the JAX package.

train → add → search / search_filter / search_batched / reconstruct / save
/ load on ``IVFn,PQm[xb]``, ``IVFn,RQMxb``, ``PQm[xb]`` and ``RQMxb`` (with
IDMap / IDMap2) through ``duckdb_faiss_ext_tpu_torch`` (on the CPU:
``config.device = "cpu"``, where K8 runs its plain version) and through
``duckdb_faiss_ext_tpu``.  The two packages' k-means draw different initial
samples (ops/kmeans.py), so parity cases train a JAX index and carry it
into the port (``from_reference`` or a checkpoint): the same centroids,
codebooks, lists and codes.  The JAX side of an IVF case runs both its
interpreted Pallas gather kernel (``set_kernel_mode("pallas")``) and its
default XLA gather path.

Tolerance: distances rtol=1e-5, atol=1e-5 times the larger of the largest
|distance| and the largest ‖q‖² (fp32 sums in another order; the JAX gather
path and both packages' spill scans take L2 in expansion form); labels equal
wherever the neighbouring distances are further apart than that.  Codes the
two packages encode from the same rows agree but at near-ties of the
encoder's costs (tests/test_torch_pq_kernels.py), so such cases compare at
least 99% of them.
"""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.models import ivf_serve

D = 16


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


def _clustered(seed, n, d=D, ncl=8, skew=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 5
    which = rng.integers(0, ncl, n)
    if skew:
        which = np.where(rng.random(n) < skew, 0, which)
    return (centers[which]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.3)


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


def _jax_both(fn, ivf=True):
    """The JAX result through its interpreted Pallas gather kernel and its
    default path (one result for a standalone PQ / RQ index)."""
    if not ivf:
        return (fn(),)
    dfx.set_kernel_mode("pallas")
    try:
        pallas = fn()
    finally:
        dfx.set_kernel_mode("auto")
    return pallas, fn()


def _carried(catalog, pcat, factory, metric, xb, ids=None, params=None,
             name="src"):
    """A JAX index trained and filled, and its copy in the port."""
    dfx.faiss_create_params(name, xb.shape[1], factory, params,
                            metric_type=metric, catalog=catalog)
    dfx.faiss_add((ids, xb) if ids is not None else xb, name,
                  catalog=catalog)
    pcat.put(name, from_reference(catalog.get(name)))


def _inner(entry):
    return getattr(entry.index, "inner", entry.index)


FACTORIES = ["IVF8,PQ4", "IDMap,IVF8,PQ4", "IDMap2,IVF8,PQ4", "IVF4,RQ2x4",
             "IVF8,RQ4x4", "PQ4", "RQ2x4", "IDMap2,PQ4"]


# --- parity with the JAX package on the same trained state -------------------

@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("factory", FACTORIES)
def test_search_matches_jax(catalog, pcat, factory, metric):
    xb = _clustered(1, 2000)
    ids = np.arange(2000, dtype=np.int64) * 3 + 7
    idmap = factory.startswith("IDMap")
    _carried(catalog, pcat, factory, metric, xb, ids if idmap else None)
    xq = _clustered(2, 12)
    params = {"nprobe": "3"}
    got = dt.faiss_search("src", 10, xq, params, catalog=pcat)
    ivf = "IVF" in factory
    for want in _jax_both(lambda: dfx.faiss_search(
            "src", 10, xq, params, catalog=catalog), ivf):
        _assert_agree(got, want, xq)
    if ivf:
        assert _inner(pcat.get("src"))._last_scan_path == "per-query"
    if idmap:
        assert set(got["label"].ravel()) <= set(ids.tolist())


@pytest.mark.parametrize("factory", ["IDMap,IVF8,PQ4", "IDMap,IVF4,RQ2x4",
                                     "IDMap,PQ4"])
def test_filtered_and_batched_search_match_jax(catalog, pcat, factory):
    xb = _clustered(3, 1500)
    ids = np.arange(1500, dtype=np.int64) + 100
    _carried(catalog, pcat, factory, "L2", xb, ids)
    xq = _clustered(4, 40)
    pdb, jdb = dt.Database(), dfx.Database()
    pdb.register("t", {"id": ids})
    jdb.register("t", {"id": ids})
    params = {"nprobe": "2"}
    ivf = "IVF" in factory
    got = dt.faiss_search_filter("src", 6, xq, "id%2==0", "id", "t", params,
                                 catalog=pcat, database=pdb)
    assert (got["label"][got["label"] >= 0] % 2 == 0).all()
    for want in _jax_both(lambda: dfx.faiss_search_filter(
            "src", 6, xq, "id%2==0", "id", "t", params, catalog=catalog,
            database=jdb), ivf):
        _assert_agree(got, want, xq)
    got = dt.faiss_search_batched("src", 5, xq, params, batch_size=16,
                                  catalog=pcat)
    _assert_agree(got, dt.faiss_search("src", 5, xq, params, catalog=pcat),
                  xq)
    for want in _jax_both(lambda: dfx.faiss_search_batched(
            "src", 5, xq, params, batch_size=16, catalog=catalog), ivf):
        _assert_agree(got, want, xq)


@pytest.mark.parametrize("factory", ["IVF8,PQ4", "IVF8,RQ4x4"])
def test_k_larger_than_a_list(catalog, pcat, factory):
    """k beyond the probed list's rows: the missing slots are label -1 and
    +inf in both packages."""
    xb = _clustered(5, 1200)
    _carried(catalog, pcat, factory, "L2", xb)
    xq = _clustered(6, 4)
    got = dt.faiss_search("src", 400, xq, {"nprobe": "1"}, catalog=pcat)
    assert (got["label"] == -1).any()
    for want in _jax_both(lambda: dfx.faiss_search(
            "src", 400, xq, {"nprobe": "1"}, catalog=catalog)):
        _assert_agree(got, want, xq)


@pytest.mark.parametrize("factory,metric", [("IVF8,PQ4", "L2"),
                                            ("IVF8,RQ4x4", "INNER_PRODUCT")])
def test_spill_layout_matches_jax(catalog, pcat, factory, metric):
    """A layout budget so small that the giant list is capped: the spill
    region's codes are decoded with their list's centroid and merged, plain
    and filtered, to the results of the uncapped layout and of the JAX
    package's gather path (its capped Pallas path stops on PQ storage with
    an UnboundLocalError in models/ivf_layout.py::_build_device_pallas, so
    it is not run here)."""
    xb = _clustered(7, 4000, skew=0.7)
    xq = xb[:8] + 0.01
    _carried(catalog, pcat, factory, metric, xb)
    pidx = pcat.get("src").index
    sel_p = dt.SetSelector(np.arange(0, 4000, 2))
    sel_j = dfx.SetSelector(np.arange(0, 4000, 2))
    params = {"nprobe": "8"}
    uncapped = [dt.faiss_search("src", 10, xq, params, catalog=pcat,
                                selector=s) for s in (None, sel_p)]
    pidx.LAYOUT_BUDGET_BYTES = pidx.nlist * 256 * pidx.pq_m
    pidx.SPILL_FRACTION_MAX = 1.0
    pidx._invalidate()
    assert pidx._layout_plan() == ("spill", 256)
    for ps, js, whole in ((None, None, uncapped[0]),
                          (sel_p, sel_j, uncapped[1])):
        got = dt.faiss_search("src", 10, xq, params, catalog=pcat,
                              selector=ps)
        assert pidx._spill is not None and pidx._spill.n > 0
        _assert_agree(got, whole, xq)
        _assert_agree(got, dfx.faiss_search("src", 10, xq, params,
                                            catalog=catalog, selector=js),
                      xq)


@pytest.mark.parametrize("factory", ["IVF8,PQ4", "IDMap,IVF4,RQ2x4"])
def test_gather_path_without_layout_plan_matches_jax(catalog, pcat, factory):
    """A layout over budget whose spill would pass SPILL_FRACTION_MAX: no
    plan, the sorted+gather residual decode scan, against the JAX package's
    XLA gather path (and its Pallas path)."""
    xb = _clustered(8, 2000, skew=0.5)
    ids = np.arange(2000, dtype=np.int64) * 2
    _carried(catalog, pcat, factory, "L2", xb,
             ids if factory.startswith("IDMap") else None)
    pidx = _inner(pcat.get("src"))
    pidx.LAYOUT_BUDGET_BYTES = 8 * 128 * pidx.pq_m
    pidx.SPILL_FRACTION_MAX = 0.0
    pidx._invalidate()
    assert pidx._layout_plan() is None
    xq = _clustered(9, 10)
    got = dt.faiss_search("src", 10, xq, {"nprobe": "3"}, catalog=pcat)
    assert pidx._last_scan_path == "gather"
    for want in _jax_both(lambda: dfx.faiss_search(
            "src", 10, xq, {"nprobe": "3"}, catalog=catalog)):
        _assert_agree(got, want, xq)


def test_large_batch_runs_in_query_blocks(pcat, monkeypatch):
    """A batch whose K8 temporaries pass SCAN_BLOCK_BYTES runs in
    power-of-two query blocks, with the results of one block."""
    xb = _clustered(10, 1000)
    xq = _clustered(11, 100)                      # padded to 128 rows
    dt.faiss_create("blk", D, "IVF4,PQ4", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "blk", catalog=pcat)
    idx = pcat.get("blk").index
    params = {"nprobe": "2"}
    whole = dt.faiss_search("blk", 5, xq, params, catalog=pcat)
    lmax = idx._build_device_layout().payload.shape[1]
    idx.SCAN_BLOCK_BYTES = 32 * 4 * 2 * (lmax + D)
    blocks = []
    real = ivf_serve.ivf_pq_list_search

    def counted(*args, **kw):
        blocks.append(args[6].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(ivf_serve, "ivf_pq_list_search", counted)
    split = dt.faiss_search("blk", 5, xq, params, catalog=pcat)
    assert blocks == [32] * 4
    _assert_agree(split, whole, xq)


@pytest.mark.parametrize("factory", ["IVF8,PQ4", "IVF4,RQ2x4", "PQ4",
                                     "RQ2x4"])
def test_reconstruct_matches_jax(catalog, pcat, factory):
    xb = _clustered(12, 1200)
    _carried(catalog, pcat, factory, "L2", xb)
    jidx, pidx = catalog.get("src").index, pcat.get("src").index
    for key in (0, 17, 1199):
        np.testing.assert_allclose(pidx.reconstruct(key),
                                   np.asarray(jidx.reconstruct(key)),
                                   rtol=1e-6, atol=1e-6)
    if "IVF" in factory:
        with pytest.raises(dt.InvalidInputError, match="out of range"):
            pidx.reconstruct(1200)


@pytest.mark.parametrize("factory", ["IDMap2,IVF8,PQ4", "IDMap2,RQ2x4"])
def test_idmap2_reconstruct_by_label(catalog, pcat, factory):
    """IDMap2 reconstructs through the coded storage by custom label
    (tests/test_ivf.py::test_idmap2_ivfpq_reconstruct)."""
    xb = _clustered(13, 1500)
    ids = np.arange(1500, dtype=np.int64) * 3 + 1
    _carried(catalog, pcat, factory, "L2", xb, ids)
    jidx, pidx = catalog.get("src").index, pcat.get("src").index
    rec = pidx.reconstruct(int(ids[7]))
    np.testing.assert_allclose(rec, np.asarray(jidx.reconstruct(int(ids[7]))),
                               rtol=1e-6, atol=1e-6)
    assert np.linalg.norm(rec - xb[7]) < 0.5 * np.linalg.norm(xb[7])
    msgs = []
    for idx in (pidx, jidx):
        with pytest.raises((dt.InvalidInputError, dfx.InvalidInputError)) \
                as exc:
            idx.reconstruct(2)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "Label 2 not found in index"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("factory", ["IDMap,IVF8,PQ4", "IVF4,RQ2x4", "PQ4",
                                     "RQ2x4"])
def test_checkpoint_cross_load(catalog, pcat, tmp_path, direction, factory):
    """A file saved by either package loads in the other, codes and
    codebooks as they were, and searches to the same results; loaded means
    immutable."""
    xb = _clustered(14, 1200)
    ids = np.arange(1200, dtype=np.int64) + 5
    xq = _clustered(15, 6)
    if direction == "jax_to_port":
        src, dst = (dfx, catalog), (dt, pcat)
    else:
        src, dst = (dt, pcat), (dfx, catalog)
    idmap = factory.startswith("IDMap")
    src[0].faiss_create("a", D, factory, metric_type="L2", catalog=src[1])
    src[0].faiss_add((ids, xb) if idmap else xb, "a", catalog=src[1])
    path = str(tmp_path / "pq.dfx")
    src[0].faiss_save("a", path, catalog=src[1])
    dst[0].faiss_load("b", path, catalog=dst[1])
    a, b = _inner(src[1].get("a")), _inner(dst[1].get("b"))
    np.testing.assert_array_equal(b._codes, a._codes)
    params = {"nprobe": "2"}
    _assert_agree(dst[0].faiss_search("b", 5, xq, params, catalog=dst[1]),
                  src[0].faiss_search("a", 5, xq, params, catalog=src[1]), xq)
    with pytest.raises(dst[0].InvalidInputError, match="immutable"):
        dst[0].faiss_add((ids, xb) if idmap else xb, "b", catalog=dst[1])


# --- create parameters -------------------------------------------------------

def _codes_agree(a, b):
    assert a.shape == b.shape
    assert (a == b).all(1).mean() >= 0.99


@pytest.mark.parametrize("factory", ["IVF8,PQ4", "PQ4"])
def test_anisotropic_eta_matches_jax(catalog, pcat, factory):
    """anisotropic_eta carried with the state; rows added to both copies
    are encoded by the score-aware loss (for IVF, along the original rows)
    to the same codes, and search to the same results."""
    xb = _clustered(16, 1500)
    _carried(catalog, pcat, factory, "INNER_PRODUCT", xb,
             params={"anisotropic_eta": "4.0"})
    jidx, pidx = catalog.get("src").index, pcat.get("src").index
    assert pidx.aniso_eta == jidx.aniso_eta == 4.0
    more = _clustered(17, 500)
    dfx.faiss_add(more, "src", catalog=catalog)
    dt.faiss_add(more, "src", catalog=pcat)
    _codes_agree(pidx._codes, jidx._codes)
    assert float(pidx.state_dict()["aniso_eta"]) == 4.0
    plain = np.asarray(jidx._codes[-500:])
    dt.faiss_create("iso", D, factory, metric_type="INNER_PRODUCT",
                    catalog=pcat)
    pcat.get("iso").index.load_state({
        k: v for k, v in pidx.state_dict().items() if k != "aniso_eta"})
    dt.faiss_add(more, "iso", catalog=pcat)
    assert not np.array_equal(pcat.get("iso").index._codes[-500:], plain)


@pytest.mark.parametrize("factory", ["IVF4,RQ2x4", "RQ2x4"])
def test_beam_matches_jax(catalog, pcat, factory):
    """The RQ encoder's beam carried with the state (``rq_beam`` for IVF,
    ``rq_meta`` standalone); rows added to both copies get the same codes."""
    xb = _clustered(18, 1500)
    _carried(catalog, pcat, factory, "L2", xb, params={"beam": "1"})
    jidx, pidx = catalog.get("src").index, pcat.get("src").index
    key = "rq_beam" if "IVF" in factory else "rq_meta"
    assert int(np.asarray(pidx.state_dict()[key]).reshape(-1)[0]) == 1
    more = _clustered(19, 500)
    dfx.faiss_add(more, "src", catalog=catalog)
    dt.faiss_add(more, "src", catalog=pcat)
    _codes_agree(pidx._codes, jidx._codes)


@pytest.mark.parametrize("factory", ["IVF8,PQ4", "IVF8,RQ2x4", "PQ4",
                                     "RQ2x8"])
def test_own_training_deterministic(pcat, factory):
    """The port trains its own codebooks, deterministically under
    train_seed, and serves its own index."""
    xb = _clustered(20, 1500)
    books = []
    for name in ("a", "b"):
        dt.faiss_create(name, D, factory, metric_type="L2", catalog=pcat)
        dt.faiss_add(xb, name, catalog=pcat)
        idx = pcat.get(name).index
        books.append(idx._pq_codebooks if "IVF" in factory
                     else idx._codebooks)
    np.testing.assert_array_equal(books[0], books[1])
    res = dt.faiss_search("a", 5, xb[:4], {"nprobe": "8"}, catalog=pcat)
    np.testing.assert_array_equal(res["label"][:, 0], np.arange(4))


def test_ivf_pq_recall_against_flat(pcat):
    """The port's own IVF8,PQ4 (tests/test_ivf.py::
    test_ivfpq_recall_and_roundtrip): recall@10 against Flat."""
    xb = _clustered(21, 3000, ncl=16)
    xq = _clustered(22, 8, ncl=16)
    dt.faiss_create("pq", D, "IVF8,PQ4", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "pq", catalog=pcat)
    dt.faiss_create("flat", D, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "flat", catalog=pcat)
    rp = dt.faiss_search("pq", 10, xq, {"nprobe": "8"}, catalog=pcat)
    rf = dt.faiss_search("flat", 10, xq, catalog=pcat)
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(rp["label"], rf["label"])])
    assert recall >= 0.4, recall
    idx = pcat.get("pq").index
    assert idx._codes.shape == (3000, 4) and idx._xb.shape[0] == 0


# --- error texts -------------------------------------------------------------

@pytest.mark.parametrize("factory,metric,params", [
    ("IVF4,PQ3", "L2", None),
    ("PQ5", "L2", None),
    ("IVF4,RQ2x9", "L2", None),
    ("RQ2x9", "L2", None),
    ("IVF4,PQ4", "L1", None),
    ("PQ4", "Linf", None),
    ("RQ2x4", "L1", None),
    ("IVF4,PQ4", "L2", {"anisotropic_eta": "0.5"}),
    ("PQ4", "L2", {"anisotropic_eta": "0.5"}),
    ("IVF4,RQ2x4", "L2", {"anisotropic_eta": "2"}),
    ("RQ2x4", "L2", {"anisotropic_eta": "2"}),
    ("IVF4,PQ4", "L2", {"beam": "2"}),
    ("IVF4,Flat", "L2", {"anisotropic_eta": "2"}),
    ("IVF4,Flat", "L2", {"beam": "2"})])
def test_error_texts_match_jax(catalog, pcat, factory, metric, params):
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_create_params("e", D, factory, params,
                                    metric_type=metric, catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert pcat.names() == []


@pytest.mark.parametrize("factory", ["IVF2,PQ2", "PQ2", "RQ2x8"])
def test_too_few_training_points_message(catalog, pcat, factory):
    """ksub = 256 codewords need 256 training rows: the same message as the
    JAX package, and the index stays untrained."""
    x = _clustered(23, 100)
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("few", D, factory, metric_type="L2", catalog=cat)
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.faiss_manual_train(x, "few", catalog=cat)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert "(256)" in msgs[1]
    assert not pcat.get("few").index.is_trained


@pytest.mark.parametrize("factory,what", [
    ("IVF4,PQ4,RFlat", "RFlat"),
    ("IMI2x2,PQ4", "IMI"),
    ("HNSW8,PQ4", "HNSW"),
    ("IVF4_HNSW8,PQ4", "IVF quantizer HNSW8"),
    ("IVF4(IVF2,Flat),PQ4", "parenthesized IVF quantizer"),
    ("OPQ4,IVF4,PQ4", "transform OPQ4")])
def test_forms_that_still_wait_are_refused(pcat, factory, what):
    with pytest.raises(dt.InvalidInputError,
                       match=f"{what} is not yet available in "
                             f"duckdb_faiss_ext_tpu_torch"):
        dt.faiss_create("e", D, factory, catalog=pcat)
    assert pcat.names() == []
