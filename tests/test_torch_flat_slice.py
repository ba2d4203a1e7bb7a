"""The port's Flat slice end to end against the JAX package.

create → add → search / search_filter / search_filter_set / search_batched
on ``Flat`` and ``IDMap,Flat`` through ``duckdb_faiss_ext_tpu_torch`` (on
the CPU: ``config.device = "cpu"``) and through ``duckdb_faiss_ext_tpu``
(parity precision), with the same numpy inputs.  Labels must be equal;
distances agree to rtol=1e-5, atol=1e-5·max|distance| (fp32 sums in
another order), and the reference's golden distances to rtol=2e-6 as in
tests/test_flat_parity.py.
"""

import gc

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from test_flat_parity import (GOLDEN_FILTERED, GOLDEN_FLAT_DISTANCES,
                              GOLDEN_LABELS)


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


def _assert_results_equal(got, want):
    np.testing.assert_array_equal(got["rank"], want["rank"])
    np.testing.assert_array_equal(got["label"], want["label"])
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(gd[~finite], wd[~finite])
    scale = float(np.abs(wd[finite]).max()) if finite.any() else 1.0
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5,
                               atol=1e-5 * scale)


# --- the reference's golden values ------------------------------------------

def test_golden_distances(training_data, query_data, pcat):
    _, xb = training_data
    _, xq = query_data
    dt.faiss_create("flat8", 8, "Flat", catalog=pcat)
    dt.faiss_add(xb, "flat8", catalog=pcat)
    res = dt.faiss_search("flat8", 2, xq, catalog=pcat)
    np.testing.assert_allclose(res["distance"].reshape(-1),
                               GOLDEN_FLAT_DISTANCES, rtol=2e-6)


def test_golden_labels(training_data, query_data, pcat):
    ids, xb = training_data
    _, xq = query_data
    dt.faiss_create("flat82", 8, "IDMap,Flat", catalog=pcat)
    dt.faiss_add((ids, xb), "flat82", catalog=pcat)
    res = dt.faiss_search("flat82", 2, xq, catalog=pcat)
    np.testing.assert_array_equal(res["label"], np.array(GOLDEN_LABELS))
    np.testing.assert_array_equal(res["rank"], np.tile([0, 1], (10, 1)))
    np.testing.assert_allclose(res["distance"].reshape(-1),
                               GOLDEN_FLAT_DISTANCES, rtol=2e-6)


@pytest.mark.parametrize("fn", ["faiss_search_filter",
                                "faiss_search_filter_set"])
def test_golden_filtered(training_data, query_data, pcat, fn):
    ids, xb = training_data
    _, xq = query_data
    dt.faiss_create("flat8f", 8, "IDMap,Flat", catalog=pcat)
    dt.faiss_add((ids, xb), "flat8f", catalog=pcat)
    db = dt.Database()
    db.register("training", {"column0": ids})
    res = getattr(dt, fn)("flat8f", 2, xq, "column0>100", "column0",
                          "training", catalog=pcat, database=db)
    gl, gd = zip(*GOLDEN_FILTERED)
    np.testing.assert_array_equal(res["label"].reshape(-1), gl)
    np.testing.assert_allclose(res["distance"].reshape(-1), gd, rtol=1e-4)


# --- the slice against the JAX package --------------------------------------

def _slice_run(mod, cat, db, table, factory, metric, batches, xq):
    mod.faiss_create("s", xq.shape[1], factory, metric_type=metric,
                     catalog=cat)
    for ids, x in batches:
        mod.faiss_add((ids, x) if factory.startswith("IDMap") else x, "s",
                      catalog=cat)
    out = {
        "search": mod.faiss_search("s", 10, xq, catalog=cat),
        "k_beyond_ntotal": mod.faiss_search("s", 400, xq[:3], catalog=cat),
        "filter": mod.faiss_search_filter("s", 10, xq, "id%2==0", "id",
                                          table, catalog=cat, database=db),
        "filter_set": mod.faiss_search_filter_set(
            "s", 10, xq, "id%3==1", "id", table, catalog=cat, database=db),
        "batched": mod.faiss_search_batched("s", 10, xq, batch_size=5,
                                            catalog=cat),
        "batched_sel": mod.faiss_search_batched(
            "s", 7, xq, batch_size=4, catalog=cat,
            selector=mod.SetSelector(np.unique(
                np.concatenate([b[0] for b in batches]))[::3])),
    }
    return out


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT", "L1"])
@pytest.mark.parametrize("factory", ["Flat", "IDMap,Flat"])
def test_slice_matches_jax(catalog, pcat, factory, metric):
    """Three adds cross the 128- and 256-row capacity buckets; every search
    entry point returns the JAX package's results."""
    rng = np.random.default_rng(11)
    sizes = [100, 60, 140]
    n = sum(sizes)
    xb = rng.standard_normal((n, 16)).astype(np.float32)
    ids = (np.arange(n, dtype=np.int64) * 7 + 3 if factory.startswith("IDMap")
           else np.arange(n, dtype=np.int64))
    cuts = np.cumsum([0] + sizes)
    batches = [(ids[a:b], xb[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    xq = rng.standard_normal((13, 16)).astype(np.float32)
    # A table name of its own per case: the JAX package caches selectors
    # under id(db), and a Database of an earlier case may have had this
    # one's address (see the last test of this file).
    table = f"t_{factory}_{metric}"
    jdb, pdb = dfx.Database(), dt.Database()
    jdb.register(table, {"id": ids})
    pdb.register(table, {"id": ids})
    want = _slice_run(dfx, catalog, jdb, table, factory, metric, batches, xq)
    got = _slice_run(dt, pcat, pdb, table, factory, metric, batches, xq)
    for key in want:
        try:
            _assert_results_equal(got[key], want[key])
        except AssertionError as e:
            raise AssertionError(f"{key}: {e}") from None
    assert (got["k_beyond_ntotal"]["label"][:, n:] == -1).all()


def test_filter_after_add_sees_new_rows(pcat):
    """A cached selector mask is rebuilt after an add: rows added later are
    filtered by the same predicate (no stale mask)."""
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((300, 8)).astype(np.float32)
    ids = np.arange(300, dtype=np.int64)
    dt.faiss_create("m", 8, "IDMap,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add((ids[:200], xb[:200]), "m", catalog=pcat)
    db = dt.Database()
    db.register("t", {"id": ids})
    dt.faiss_search_filter("m", 5, xb[250:260], "id%2==0", "id", "t",
                           catalog=pcat, database=db)
    dt.faiss_add((ids[200:], xb[200:]), "m", catalog=pcat)
    res = dt.faiss_search_filter("m", 5, xb[250:260], "id%2==0", "id", "t",
                                 catalog=pcat, database=db)
    assert (res["label"] % 2 == 0).all()
    even = np.arange(250, 260) % 2 == 0
    np.testing.assert_array_equal(res["label"][even, 0],
                                  np.arange(250, 260)[even])


def test_rerank_param_in_fast_mode(pcat):
    """{"rerank": "true"} in fast mode re-scores in fp32: the same labels
    and distances as parity mode."""
    rng = np.random.default_rng(9)
    xb = rng.standard_normal((500, 16)).astype(np.float32)
    dt.faiss_create("r", 16, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "r", catalog=pcat)
    ref = dt.faiss_search("r", 5, xb[:9], catalog=pcat)
    dt.set_precision("fast")
    try:
        got = dt.faiss_search("r", 5, xb[:9], {"rerank": "true"},
                              catalog=pcat)
    finally:
        dt.set_precision("parity")
    _assert_results_equal(got, ref)


# --- lifecycle errors: the JAX package's exact messages ---------------------

def _err_mixing_with(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "IDMap,Flat", catalog=cat)
    mod.faiss_add((ids, xb), "e", catalog=cat)
    mod.faiss_add(xb, "e", catalog=cat)


def _err_mixing_without(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "Flat", catalog=cat)
    mod.faiss_add(xb, "e", catalog=cat)
    mod.faiss_add((ids, xb), "e", catalog=cat)


def _err_add_ids_plain_flat(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "Flat", catalog=cat)
    mod.faiss_add((ids, xb), "e", catalog=cat)


def _err_unknown_index(mod, cat, xb, ids):
    mod.faiss_search("nope", 2, xb[:2], catalog=cat)


def _err_duplicate_name(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "Flat", catalog=cat)
    mod.faiss_create("e", 8, "Flat", catalog=cat)


def _err_bad_vector_length(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "Flat", catalog=cat)
    mod.faiss_add(xb[:, :5], "e", catalog=cat)


def _err_unknown_metric(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "Flat", metric_type="Invalid", catalog=cat)


def _err_unknown_named_param(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "Flat", bogus=1, catalog=cat)


def _err_parse(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "IDMap,Flat,PQ4", catalog=cat)


def _err_parse_unknown_component(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "IVF8(Bogus),Flat", catalog=cat)


def _err_batch_size(mod, cat, xb, ids):
    mod.faiss_create("e", 8, "Flat", catalog=cat)
    mod.faiss_search_batched("e", 2, xb[:3], batch_size=0, catalog=cat)


def _err_immutable_after_load(mod, cat, xb, ids, path):
    mod.faiss_create("e", 8, "Flat", catalog=cat)
    mod.faiss_add(xb, "e", catalog=cat)
    mod.faiss_save("e", path, catalog=cat)
    mod.faiss_load("loaded", path, catalog=cat)
    mod.faiss_add(xb, "loaded", catalog=cat)


ERROR_CASES = [_err_mixing_with, _err_mixing_without, _err_add_ids_plain_flat,
               _err_unknown_index, _err_duplicate_name, _err_bad_vector_length,
               _err_unknown_metric, _err_unknown_named_param, _err_parse,
               _err_parse_unknown_component, _err_batch_size,
               _err_immutable_after_load]


@pytest.mark.parametrize("case", ERROR_CASES, ids=lambda f: f.__name__[5:])
def test_lifecycle_error_messages(catalog, pcat, tmp_path, case, training_data):
    ids, xb = training_data
    msgs = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        extra = ((str(tmp_path / f"{mod.__name__}.idx"),)
                 if case is _err_immutable_after_load else ())
        with pytest.raises(mod.InvalidInputError) as exc:
            case(mod, cat, xb, ids, *extra)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_unported_family_is_refused(pcat):
    with pytest.raises(dt.InvalidInputError,
                       match="HNSW is not yet available in "
                             "duckdb_faiss_ext_tpu_torch"):
        dt.faiss_create("e", 8, "IDMap,HNSW32", catalog=pcat)
    assert pcat.names() == []


# --- carrying state across ---------------------------------------------------

def _filled_jax_index(catalog, factory):
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((180, 12)).astype(np.float32)
    ids = np.arange(180, dtype=np.int64) * 5 + 1
    dfx.faiss_create("src", 12, factory, metric_type="L2", catalog=catalog)
    dfx.faiss_add((ids, xb) if factory.startswith("IDMap") else xb, "src",
                  catalog=catalog)
    return xb


@pytest.mark.parametrize("factory", ["Flat", "IDMap,Flat"])
def test_from_reference(catalog, pcat, factory):
    xb = _filled_jax_index(catalog, factory)
    src = catalog.get("src")
    for obj in (src, src.index):
        pcat.put("dst", from_reference(obj))
        _assert_results_equal(dt.faiss_search("dst", 6, xb[:7], catalog=pcat),
                              dfx.faiss_search("src", 6, xb[:7],
                                               catalog=catalog))
    assert pcat.get("dst").custom_labels == factory.startswith("IDMap")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_cross_load(catalog, pcat, tmp_path, direction):
    """A file saved by either package loads in the other (same npz + JSON
    header) and searches to the same results; loaded means immutable."""
    rng = np.random.default_rng(4)
    xb = rng.standard_normal((150, 8)).astype(np.float32)
    ids = np.arange(150, dtype=np.int64) + 1000
    src, dst = ((dfx, catalog), (dt, pcat))
    if direction == "port_to_jax":
        src, dst = dst, src
    path = str(tmp_path / "ck.idx")
    src[0].faiss_create("a", 8, "IDMap,Flat", metric_type="L2",
                        catalog=src[1])
    src[0].faiss_add((ids, xb), "a", catalog=src[1])
    src[0].faiss_save("a", path, catalog=src[1])
    dst[0].faiss_load("b", path, catalog=dst[1])
    _assert_results_equal(dst[0].faiss_search("b", 5, xb[:6], catalog=dst[1]),
                          src[0].faiss_search("a", 5, xb[:6], catalog=src[1]))
    assert not dst[1].get("b").is_mutable


# --- a fault of the JAX package the port does not inherit -------------------

def test_selector_cache_not_keyed_on_database_address(pcat):
    """Deviation from the JAX package (api.py:318-319 there): its filtered
    search caches selectors under id(db), and CPython hands a collected
    Database's address to the next one, so a new Database holding a table
    of the same name and version could be served the old table's selector.
    The port keys on Database.uid, which is never reused."""
    xb = np.eye(8, dtype=np.float32)
    dt.faiss_create("u", 8, "IDMap,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add((np.arange(8, dtype=np.int64), xb), "u", catalog=pcat)
    seen = set()
    for flag in range(6):
        db = dt.Database()
        assert db.uid not in seen
        seen.add(db.uid)
        # Same table name, same version (1), alternating contents.
        db.register("t", {"id": np.arange(8, dtype=np.int64),
                          "keep": np.full(8, flag % 2)})
        res = dt.faiss_search_filter("u", 8, xb[:1], "keep==1", "id", "t",
                                     catalog=pcat, database=db)
        got = res["label"][res["label"] >= 0]
        assert (got.size == 8) if flag % 2 else (got.size == 0)
        del db
        gc.collect()
