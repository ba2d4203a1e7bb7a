"""The unpadded IVF,Flat layout (models/ivf_layout.py::UnpaddedLayout).

A Flat index whose padded layout would pass its budget keeps its rows in
storage order and indexes its lists (``row_pos``, ``offsets``); K6 reads
them in place.  Held here against a plain float64 reference on seeded
skewed data: L2 and inner product, host-built and device-resident indexes,
unfiltered and filtered (bitmap and set selectors): every answer is the
exact top k of the passing rows within the probed lists.  A filtered
search reads the selector's pass index, held bit for bit against K6 over
the full layout with the selector's slot mask.  K6's plain
version on the unpadded contract against numpy; the padded layout's
answers at a SIFT-shaped configuration; the counters and the errors.  On
the CPU, one torch thread, small n.
"""

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch import errors
from duckdb_faiss_ext_tpu_torch.models import ivf_layout
from duckdb_faiss_ext_tpu_torch.models.base import map_labels
from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
from duckdb_faiss_ext_tpu_torch.ops.bitmap import build_bitmap
from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores
from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
from duckdb_faiss_ext_tpu_torch.params import ParamMap
from duckdb_faiss_ext_tpu_torch.sql.engine import Database
from duckdb_faiss_ext_tpu_torch.utils.config import config, next_pow2
from duckdb_faiss_ext_tpu_torch.utils.profiling import counters

N, D, NLIST, NPROBE, K = 3000, 16, 8, 3, 10


@pytest.fixture(autouse=True)
def cpu_one_thread():
    dt.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def skewed(seed, n=N, d=D, skew=0.6):
    """Clusters of uneven size: ``skew`` of the rows in the first."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)) * 4
    which = np.where(rng.random(n) < skew, 0, rng.integers(0, 8, n))
    return (centers[which] + rng.standard_normal((n, d))).astype(np.float32)


def exact(xb, xq, cent, metric, k, passing=None, nprobe=NPROBE):
    """float64 top-k labels and scores of the passing rows in each query's
    nprobe nearest lists, each row in its nearest list."""
    x, q, c = (a.astype(np.float64) for a in (xb, xq, cent))
    if metric == "L2":
        def score(a, b):
            return -((a[:, None, :] - b[None]) ** 2).sum(-1)
    else:
        def score(a, b):
            return a @ b.T
    assign = score(x, c).argmax(1)
    probes = np.argsort(-score(q, c), 1, kind="stable")[:, :nprobe]
    s = score(q, x)
    ok = np.stack([np.isin(assign, p) for p in probes])
    if passing is not None:
        ok &= passing[None, :]
    s = np.where(ok, s, -np.inf)
    top = np.argsort(-s, 1, kind="stable")[:, :k]
    return top, np.take_along_axis(s, top, 1)


def assert_exact(got, xb, xq, cent, metric, passing=None):
    """Every answer the exact top k (labels where scores are apart, and
    the scores to rounding)."""
    top, s = exact(xb, xq, cent, metric, K, passing)
    sign = -1.0 if metric == "L2" else 1.0
    np.testing.assert_allclose(sign * got["distance"].astype(np.float64), s,
                               rtol=1e-4, atol=1e-3)
    apart = np.ones_like(s, bool)
    gap = np.abs(np.diff(s, axis=1)) > 1e-3
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][apart], top[apart])


def build(kind, metric, xb, budget=True):
    """An IVF8,Flat over ``xb``: host-built (``faiss_add`` with a budget
    that the padded layout passes) or device-resident (``layout`` left to
    choose, with a budget that the padded payload passes)."""
    cat = dt.Catalog()
    dt.faiss_create("u", D, f"IVF{NLIST},Flat", metric_type=metric,
                    catalog=cat)
    ix = cat.get("u").index
    if budget:
        ix.LAYOUT_BUDGET_BYTES = NLIST * 256 * D * 4
    if kind == "host":
        dt.faiss_add(xb, "u", catalog=cat)
    else:
        dt.faiss_train_device(torch.from_numpy(xb[:1500]), "u", catalog=cat)
        dt.faiss_add_device(torch.from_numpy(xb[:1000]), "u",
                            expected_total=N, catalog=cat)
        dt.faiss_add_device(torch.from_numpy(xb[1000:]), "u", catalog=cat)
    return cat, ix


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("filt", [None, "bitmap", "set"])
def test_unpadded_search_is_exact(kind, metric, filt):
    xb = skewed(1)
    xq = skewed(2, n=12)
    cat, ix = build(kind, metric, xb)
    assert ix._layout_plan() == ("unpadded", None)
    keep = np.arange(0, N, 3)
    sel = passing = None
    if filt == "bitmap":
        sel = build_bitmap(np.ones(keep.size, np.uint8), keep)
    elif filt == "set":
        sel = dt.SetSelector(keep)
    if sel is not None:
        passing = np.zeros(N, bool)
        passing[keep] = True
    before = counters()["models.unpadded_searches"]
    got = dt.faiss_search("u", K, xq, {"nprobe": str(NPROBE)}, catalog=cat,
                          selector=sel)
    assert counters()["models.unpadded_searches"] == before + 1
    assert ix._last_scan_path == "unpadded"
    assert_exact(got, xb, xq, ix.centroids, metric, passing)
    lay = ix._build_unpadded_layout()
    assert lay.lmax == int(np.bincount(ix._assign).max())


def test_unpadded_layout_is_a_stable_index_of_the_lists():
    xb = skewed(3)
    cat, ix = build("host", "L2", xb)
    lay = ix._build_unpadded_layout()
    assign = ix._assign
    want = np.argsort(assign, kind="stable")
    np.testing.assert_array_equal(lay.row_pos.numpy(), want)
    np.testing.assert_array_equal(
        lay.offsets.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(assign,
                                                   minlength=NLIST))]))
    assert lay.payload.shape == (N, D)
    assert torch.equal(lay.payload, torch.from_numpy(xb))


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_device_and_host_unpadded_agree_and_checkpoint(metric, tmp_path):
    """The device-resident unpadded index answers as the host-built one
    over the same trained state, reconstructs its rows, and saves as an
    ordinary host-path checkpoint."""
    xb = skewed(4)
    xq = skewed(5, n=8)
    dcat, dix = build("device", metric, xb)
    hcat = dt.Catalog()
    dt.faiss_create("u", D, f"IVF{NLIST},Flat", metric_type=metric,
                    catalog=hcat)
    hix = hcat.get("u").index
    hix.LAYOUT_BUDGET_BYTES = dix.LAYOUT_BUDGET_BYTES
    hix.load_state({"xb": np.empty((0, D), np.float32),
                    "ids": np.empty(0, np.int64),
                    "assign": np.empty(0, np.int32),
                    "centroids": np.array(dix.centroids)})
    dt.faiss_add(xb, "u", catalog=hcat)
    assert hix._layout_plan() == dix._layout_plan() == ("unpadded", None)
    params = {"nprobe": str(NPROBE)}
    got = dt.faiss_search("u", K, xq, params, catalog=dcat)
    want = dt.faiss_search("u", K, xq, params, catalog=hcat)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["distance"], want["distance"])
    np.testing.assert_array_equal(dix.reconstruct(1234), xb[1234])
    path = str(tmp_path / "u.dfx")
    dt.faiss_save("u", path, catalog=dcat)
    dt.faiss_load("v", path, catalog=dcat)
    again = dt.faiss_search("v", K, xq, params, catalog=dcat)
    np.testing.assert_array_equal(again["label"], got["label"])


def test_filtered_calls_build_the_selector_and_mask_once():
    """faiss_search_filter over a registered table: the filter is
    evaluated (``api.filter_eval``) and the mask aligned with the unpadded
    slots once for every call."""
    xb = skewed(6)
    xq = skewed(7, n=6)
    cat, ix = build("device", "INNER_PRODUCT", xb)
    db = Database()
    i = np.arange(N, dtype=np.int64)
    db.register("ids", {"i": i, "sel": i % 100})
    c0 = counters()
    for _ in range(4):
        got = dt.faiss_search_filter("u", K, xq, "sel < 10", "i", "ids",
                                     {"nprobe": str(NPROBE)}, catalog=cat,
                                     database=db)
    c1 = counters()
    assert c1["api.selector_builds"] - c0["api.selector_builds"] == 1
    assert c1["models.mask_builds"] - c0.get("models.mask_builds", 0) == 1
    assert c1["models.unpadded_searches"] - \
        c0["models.unpadded_searches"] == 4
    assert_exact(got, xb, xq, ix.centroids, "INNER_PRODUCT", i % 100 < 10)


def selector_of(kind, passing):
    """A bitmap or set selector passing the labels where ``passing``."""
    if kind == "bitmap":
        return build_bitmap(passing.astype(np.uint8),
                            np.arange(passing.size, dtype=np.int64))
    return dt.SetSelector(np.flatnonzero(passing))


def pass_rule(rate, ix, xq):
    """(N,) bool: ``rate`` % of the rows by label; "no-list": a third of
    the rows, none in the first query's best list."""
    i = np.arange(N)
    if rate == "no-list":
        probe = coarse_topk(torch.from_numpy(xq), ix._build_unpadded_layout()
                            .centroids, NPROBE, ix.metric.name,
                            ix.metric_arg)
        return (i % 3 == 0) & (ix._assign != int(probe[0, 0]))
    return i % 100 < rate


def mask_path(ix, xq, k, sel):
    """K6 over the full unpadded layout with the selector's (n,) slot mask,
    the search the pass index replaced: finalized (distances, positions)
    of the padded batch."""
    lay = ix._build_unpadded_layout()
    mask = ix._row_mask(sel, lay.row_pos)
    nq_pad = max(config.min_query_bucket, next_pow2(xq.shape[0]))
    q = torch.from_numpy(np.pad(xq, ((0, nq_pad - xq.shape[0]), (0, 0)),
                                mode="edge"))
    metric = ix.metric.name
    probe = coarse_topk(q, lay.centroids, NPROBE, metric, ix.metric_arg)
    s, p = k6.ivf_list_search(lay.payload, lay.counts, lay.row_pos, probe, q,
                              mask, k=min(k, NPROBE * lay.lmax),
                              metric=metric, offsets=lay.offsets,
                              lmax=lay.lmax)
    return finalize_scores(s, p, metric)


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("kind", ["bitmap", "set"])
@pytest.mark.parametrize("rate", [0, 1, 10, 100, "no-list"])
@pytest.mark.parametrize("k", [K, k6.MAX_K + 1])
def test_pass_index_answers_as_the_mask_path(metric, kind, rate, k):
    """A filtered search through the pass index returns bit for bit the
    distances and positions of K6 over the full layout with the slot mask:
    pass rates 0-100%, a probed list with no passing row, fewer passing
    rows than k, k above K6's limit, and every row stored twice, so that
    equal scores must resolve to the same rows."""
    xb = skewed(14)
    xb[1::2] = xb[::2]
    xq = skewed(15, n=6)
    cat, ix = build("host", metric, xb)
    passing = pass_rule(rate, ix, xq)
    sel = selector_of(kind, passing)
    want_d, want_p = mask_path(ix, xq, k, sel)
    c0 = counters()
    disp = ix.search_dispatch(xq, k, ParamMap({"nprobe": str(NPROBE)}), sel)
    assert counters()["models.pass_index_searches"] == \
        c0["models.pass_index_searches"] + 1
    nq, pos = disp.nq, disp.pos
    assert (nq, disp.k_eff) == (xq.shape[0], want_d.shape[1])
    assert torch.equal(disp.dist, want_d) and torch.equal(pos, want_p)
    got = pos[:nq][pos[:nq] >= 0].numpy()
    assert passing[map_labels(got, disp.tables)].all()
    if rate == 0:
        assert (pos == -1).all()


@pytest.mark.parametrize("kind", ["bitmap", "set"])
@pytest.mark.parametrize("rate", [0, 10])
def test_pass_index_is_the_passing_subsequence(kind, rate):
    """The pass index holds each list's passing slots in slot order, its
    offsets are the exclusive sum of its counts, its longest list is at
    least 1; it shares the payload, is built once per selector and again
    after an add."""
    xb = skewed(16)
    xq = skewed(17, n=4)
    cat, ix = build("host", "L2", xb)
    passing = pass_rule(rate, ix, xq)
    sel = selector_of(kind, passing)
    lay = ix._build_unpadded_layout()
    c0 = counters()
    idx = ix._layout_filter(sel)
    assert ix._layout_filter(sel) is idx
    assert counters()["models.mask_builds"] - c0["models.mask_builds"] == 1
    keep = passing[lay.row_pos.numpy()]
    np.testing.assert_array_equal(idx.row_pos.numpy(),
                                  lay.row_pos.numpy()[keep])
    counts = np.add.reduceat(np.r_[keep, False].astype(np.int64),
                             lay.offsets.numpy()[:-1])
    counts[np.diff(lay.offsets.numpy()) == 0] = 0
    np.testing.assert_array_equal(idx.counts.numpy(), counts)
    np.testing.assert_array_equal(idx.offsets.numpy(),
                                  np.r_[0, np.cumsum(counts)])
    assert idx.counts.dtype == idx.offsets.dtype == torch.int32
    assert idx.lmax == max(1, int(counts.max())) >= 1
    assert idx.payload is lay.payload and idx.centroids is lay.centroids
    params = {"nprobe": str(NPROBE)}
    c1 = counters()
    for _ in range(2):
        dt.faiss_search("u", K, xq, params, catalog=cat, selector=sel)
    dt.faiss_add(skewed(18, n=30), "u", catalog=cat)
    dt.faiss_search("u", K, xq, params, catalog=cat, selector=sel)
    c2 = counters()
    assert c2["models.mask_builds"] - c1["models.mask_builds"] == 1
    assert c2["models.pass_index_searches"] - \
        c1["models.pass_index_searches"] == 3
    assert ix._layout_filter(sel).row_pos.shape[0] >= idx.row_pos.shape[0]


def test_pass_index_counts_only_filtered_unpadded_searches():
    """``models.pass_index_searches`` rises by one a filtered search of the
    unpadded layout, and not on an unfiltered one or on the padded
    layout."""
    xb = skewed(19)
    xq = skewed(20, n=4)
    sel = dt.SetSelector(np.arange(0, N, 7))
    params = {"nprobe": str(NPROBE)}
    for budget, filtered, rises in ((True, True, 1), (True, False, 0),
                                    (False, True, 0)):
        cat, ix = build("host", "L2", xb, budget=budget)
        assert (ix._layout_plan()[0] == "unpadded") == budget
        c0 = counters()
        dt.faiss_search("u", K, xq, params, catalog=cat,
                        selector=sel if filtered else None)
        c1 = counters()
        assert c1["models.pass_index_searches"] - \
            c0["models.pass_index_searches"] == rises
        assert c1["models.unpadded_searches"] - \
            c0["models.unpadded_searches"] == int(budget)


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("masked", [False, True])
def test_k6_plain_version_on_the_unpadded_contract(metric, masked):
    """K6's plain version, its walk of the fused search's partition, the
    raw route above its k limit and the resolve, over an unpadded layout (each list's slots a scattered
    draw of storage rows), against numpy."""
    rng = np.random.default_rng(8)
    nlist, nq, nprobe, d, k = 6, 5, 3, 12, 7
    counts = np.array([0, 40, 3, 77, 1, 25], np.int32)
    n = int(counts.sum())
    rows = rng.permutation(n + 30)[:n].astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    payload = rng.standard_normal((n + 30, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    probes = np.stack([rng.permutation(nlist)[:nprobe]
                       for _ in range(nq)]).astype(np.int32)
    mask = (rng.random(n) < 0.5).astype(np.int8) if masked else None
    t = torch.from_numpy
    args = (t(payload), t(counts), t(rows), t(probes), t(xq),
            None if mask is None else t(mask))
    lmax = int(counts.max())
    s, p = k6.ivf_list_search(*args, k=k, metric=metric, offsets=t(offsets),
                              lmax=lmax)
    ws, wp = k6.walk(*args, k=k, metric=metric, n_sm=4, offsets=t(offsets),
                     lmax=lmax)
    for i in range(nq):
        slots = np.concatenate([np.arange(offsets[lid], offsets[lid + 1])
                                for lid in probes[i]])
        if mask is not None:
            slots = slots[mask[slots] != 0]
        x = payload[rows[slots]].astype(np.float64)
        q = xq[i].astype(np.float64)
        sc = (-((x - q) ** 2).sum(1) if metric == "L2" else x @ q)
        order = np.argsort(-sc, kind="stable")[:k]
        m = order.size
        np.testing.assert_allclose(s[i, :m].numpy(), sc[order], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(p[i, :m].numpy(), rows[slots][order])
        assert (p[i, m:] == -1).all() and torch.isneginf(s[i, m:]).all()
        np.testing.assert_array_equal(wp[i].numpy(), p[i].numpy())
    rs, rp = k6.ivf_list_search_raw(*args, k=k, metric=metric,
                                    offsets=t(offsets), lmax=lmax)
    assert torch.equal(rs, s) and torch.equal(rp, p)


def test_padded_answers_unchanged_at_sift_shape():
    """A SIFT-shaped IVF,Flat (L2, d 128, clustered, within budget) keeps
    the padded layout, and its answers are the exact ones; the same index
    made to take the unpadded layout answers the same."""
    rng = np.random.default_rng(9)
    n, d, nlist, nprobe = 4096, 128, 16, 4
    centers = rng.standard_normal((32, d)) * 4
    xb = (centers[rng.integers(0, 32, n)]
          + rng.standard_normal((n, d))).astype(np.float32)
    xq = (centers[rng.integers(0, 32, 8)]
          + rng.standard_normal((8, d))).astype(np.float32)
    cat = dt.Catalog()
    dt.faiss_create("s", d, f"IVF{nlist},Flat", metric_type="L2",
                    catalog=cat)
    dt.faiss_add(xb, "s", catalog=cat)
    ix = cat.get("s").index
    assert ix._layout_plan() == ("full", None)
    params = {"nprobe": str(nprobe)}
    padded = dt.faiss_search("s", K, xq, params, catalog=cat)
    assert ix._last_scan_path == "per-query"
    top, s = exact(xb, xq, ix.centroids, "L2", K, nprobe=nprobe)
    np.testing.assert_array_equal(padded["label"], top)
    np.testing.assert_allclose(-padded["distance"].astype(np.float64), s,
                               rtol=1e-5)
    ix.LAYOUT_BUDGET_BYTES = 1
    ix._invalidate()
    unpadded = dt.faiss_search("s", K, xq, params, catalog=cat)
    assert ix._last_scan_path == "unpadded"
    np.testing.assert_array_equal(unpadded["label"], padded["label"])
    np.testing.assert_array_equal(unpadded["distance"], padded["distance"])


def test_unpadded_k_past_every_probed_row():
    """k above the probed rows: the answer pads with label -1."""
    xb = skewed(10, n=600)
    cat = dt.Catalog()
    dt.faiss_create("u", D, f"IVF{NLIST},Flat", metric_type="L2",
                    catalog=cat)
    ix = cat.get("u").index
    ix.LAYOUT_BUDGET_BYTES = 1
    dt.faiss_add(xb, "u", catalog=cat)
    got = dt.faiss_search("u", 700, xb[:2], {"nprobe": "1"}, catalog=cat)
    probed = np.bincount(ix._assign).max()
    assert (got["label"][:, probed:] == -1).all()
    assert ix._layout_plan() == ("unpadded", None)


@pytest.mark.parametrize("storage,lmax,unpadded", [
    ("Flat", None, True), ("Flat", 128, False), ("SQ8", None, False)])
def test_device_ingest_chooses_its_layout(storage, lmax, unpadded):
    """A device-resident index is unpadded where its padded payload sized
    from expected_total would pass the budget: Flat storage with no lmax;
    an explicit lmax, or SQ codes, keep the padded layout."""
    xb = skewed(13, n=800)
    cat = dt.Catalog()
    dt.faiss_create("f", D, f"IVF{NLIST},{storage}", metric_type="L2",
                    catalog=cat)
    ix = cat.get("f").index
    ix.LAYOUT_BUDGET_BYTES = 1
    dt.faiss_train_device(torch.from_numpy(xb), "f", catalog=cat)
    dt.faiss_add_device(torch.from_numpy(xb), "f", expected_total=800,
                        lmax=lmax, catalog=cat)
    assert (ix._layout_plan() == ("unpadded", None)) == unpadded


def test_unpadded_grows_and_refuses_what_does_not_fit(monkeypatch):
    """More rows than expected grow the buffer; rows that would not fit
    the card's memory raise before anything is written."""
    xb = skewed(11, n=800)
    cat = dt.Catalog()
    dt.faiss_create("f", D, f"IVF{NLIST},Flat", catalog=cat)
    ix = cat.get("f").index
    ix.LAYOUT_BUDGET_BYTES = 1
    dt.faiss_train_device(torch.from_numpy(xb), "f", catalog=cat)
    dt.faiss_add_device(torch.from_numpy(xb[:400]), "f", expected_total=300,
                        catalog=cat)
    dt.faiss_add_device(torch.from_numpy(xb[400:]), "f", catalog=cat)
    assert ix._dr.n == 800 and ix._dr.payload.shape[0] >= 800
    assert torch.equal(ix._dr.payload[:800], torch.from_numpy(xb))
    monkeypatch.setattr(ivf_layout, "device_memory_bytes",
                        lambda dev: 800 * D * 4)
    with pytest.raises(errors.InvalidInputError, match="do not fit"):
        dt.faiss_add_device(torch.from_numpy(xb[:100]), "f", catalog=cat)
    assert ix._dr.n == 800


def test_centroids_accessor_is_read_only():
    xb = skewed(12, n=800)
    cat = dt.Catalog()
    dt.faiss_create("c", D, f"IVF{NLIST},Flat", catalog=cat)
    ix = cat.get("c").index
    assert ix.centroids is None
    dt.faiss_add(xb, "c", catalog=cat)
    cent = ix.centroids
    assert cent.shape == (NLIST, D) and cent.dtype == np.float32
    np.testing.assert_array_equal(cent, ix._centroids)
    with pytest.raises(ValueError):
        cent[0, 0] = 1.0
