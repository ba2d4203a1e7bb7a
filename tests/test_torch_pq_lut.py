"""The IVF-PQ / IVF-RQ table-form search (K8's algorithm) on the CPU.

K8 scores each probed row from the query's distance table (LUT-ADC) and the
row term ‖res‖² + 2⟨c, res⟩, keeps the best k + m rows of each (probe split,
warp) by that score, merges them and rescores them exactly.  The kernels
run only on the card; here their plain versions in
``duckdb_faiss_ext_tpu_torch/ops/ivf_pq_scan.py`` are held against

* float64 numpy: the distance table and the layout's row terms;
* ``ivf_pq_scan_reference`` (the raw difference-form scores): the table
  form, within the stated ``error_bound``;
* ``ivf_pq_list_search`` on CPU tensors (raw scores + ``exact_topk``) and
  the JAX package's ``pallas_ivf_pq_search`` with its gather kernel
  interpreted: the walk of the three launches on the kernels' own plan.

Inputs are made from numpy with a seed.  Tolerances: the table within 1e-5
of each query's scale (float32 sums in another order than float64); the
walk equal to the plain search exactly whenever no query is unproven (the
walk rescores with the plain scores themselves), and to the JAX package as
tests/test_torch_pq_kernels.py compares them (1e-5 of each query's scale,
positions where the scores are apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.ops.pallas_ivf import pallas_ivf_pq_search
from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8
from duckdb_faiss_ext_tpu_torch.ops.pq import codec_decode

NLIST, LMAX = 8, 128
REL_TOL = 1e-5
CODECS = [("pq", 4, 8), ("pq", 8, 4), ("rq", 2, 4), ("rq", 4, 8)]
NAMES = ("lists", "counts", "row_pos", "cb", "cents", "probe", "xq")


def _put(row, lid, at):
    """Probe list ``lid`` at slot ``at`` of a probe row, keeping the row's
    lists distinct."""
    j = np.flatnonzero(row == lid)
    if j.size:
        row[j[0]] = row[at]
    row[at] = lid


def _layout(seed, codec, m, nbits, d, nq, nprobe):
    """A padded (nlist, lmax, m) code layout with one list at count == lmax,
    one empty list and duplicated rows (exact ties), its row positions,
    codebooks, centroids, a probe table, queries and a mask."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(20, LMAX, NLIST).astype(np.int32)
    counts[1], counts[2] = LMAX, 0
    lists = rng.integers(0, 1 << nbits, (NLIST, LMAX, m)).astype(np.uint8)
    lists[:, 5] = lists[:, 4]                       # ties inside each list
    lists *= (np.arange(LMAX)[None, :] < counts[:, None])[:, :, None]
    row_pos = np.full((NLIST, LMAX), -1, np.int32)
    start = 0
    for li, c in enumerate(counts):
        row_pos[li, :c] = np.arange(start, start + c)
        start += c
    probe = np.stack([rng.choice(NLIST, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    _put(probe[0], 2, 0)                            # the empty list
    _put(probe[1 % nq], 1, nprobe - 1)              # the full list
    dim = d // m if codec == "pq" else d
    return dict(lists=lists, counts=counts, row_pos=row_pos,
                cb=rng.standard_normal((m, 1 << nbits, dim)).astype(
                    np.float32),
                cents=rng.standard_normal((NLIST, d)).astype(np.float32),
                probe=probe,
                xq=rng.standard_normal((nq, d)).astype(np.float32),
                mask=(rng.random((NLIST, LMAX)) < 0.6).astype(np.int8))


def _tensors(L):
    return {n: torch.from_numpy(L[n]) for n in L}


def _row_terms(t, codec):
    return k8.pq_row_terms(t["lists"], t["counts"], t["cents"], t["cb"],
                           codec)


def _assert_search_agrees(got, want, xq):
    gs, gp = (np.asarray(x) for x in got)
    ws, wp = (np.asarray(x) for x in want)
    finite = np.isfinite(ws)
    np.testing.assert_array_equal(np.isneginf(gs), np.isneginf(ws))
    np.testing.assert_array_equal(gp[~finite], wp[~finite])
    tol = REL_TOL * np.maximum(np.abs(np.where(finite, ws, 0)).max(1),
                               (xq * xq).sum(1))
    diff = np.abs(np.where(finite, gs - ws, 0))
    assert (diff <= tol[:, None]).all(), diff.max()
    gap = np.abs(np.diff(np.where(finite, ws, -1e30), axis=1)) \
        > 2 * tol[:, None]
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(gp[sep], wp[sep])


# --- the distance table and the row terms -----------------------------------

@pytest.mark.parametrize("codec,m,nbits", CODECS)
def test_lut_matches_float64(codec, m, nbits):
    """lut[q, s, j] = ⟨q over subspace s, cb[s][j]⟩ (PQ) or ⟨q, cb[s][j]⟩
    (RQ), and each stage's largest squared entry norm."""
    L = _layout(1, codec, m, nbits, 16, 6, 3)
    t = _tensors(L)
    lut = k8.pq_lut_reference(t["xq"], t["cb"], codec)
    cbn = k8.codebook_norms(t["cb"])
    xq, cb = L["xq"].astype(np.float64), L["cb"].astype(np.float64)
    if codec == "pq":
        want = np.einsum("qsd,sjd->qsj", xq.reshape(6, m, -1), cb)
    else:
        want = np.einsum("qd,sjd->qsj", xq, cb)
    assert lut.shape == (6, m, 1 << nbits) and lut.dtype == torch.float32
    scale = np.abs(xq).sum(1).max() * np.abs(cb).max()
    np.testing.assert_allclose(lut.numpy(), want, rtol=0,
                               atol=REL_TOL * scale)
    np.testing.assert_allclose(cbn.numpy(), (cb * cb).sum(-1).max(1),
                               rtol=1e-6)


@pytest.mark.parametrize("codec,m,nbits", CODECS)
def test_row_terms_match_float64(codec, m, nbits):
    """rt = ‖res‖² + 2⟨c, res⟩ of every live slot, 0 past the count (the
    empty list all 0, the full list all live)."""
    L = _layout(2, codec, m, nbits, 16, 4, 3)
    rt = _row_terms(_tensors(L), codec).numpy()
    res = codec_decode(torch.from_numpy(L["lists"].reshape(-1, m)),
                       torch.from_numpy(L["cb"]).double(), codec).numpy()
    res = res.reshape(NLIST, LMAX, -1)
    cents = L["cents"].astype(np.float64)[:, None, :]
    want = (res * res).sum(-1) + 2 * (cents * res).sum(-1)
    live = np.arange(LMAX)[None, :] < L["counts"][:, None]
    assert (rt[~live] == 0).all() and live[1].all() and not live[2].any()
    scale = ((res * res).sum(-1) + 2 * np.abs(cents * res).sum(-1)).max()
    np.testing.assert_allclose(rt[live], want[live], rtol=0,
                               atol=REL_TOL * scale)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,m,nbits", CODECS)
def test_table_form_within_error_bound(codec, m, nbits, metric, masked):
    """The partial launch's table scores against the raw difference-form
    scores: the same live slots (counts 0 and lmax, the mask), and every
    score within the stated bound E of its query."""
    d, nq, nprobe = 16, 8, 4
    L = _layout(3, codec, m, nbits, d, nq, nprobe)
    t = _tensors(L)
    mask = t["mask"] if masked else None
    lut = k8.pq_lut_reference(t["xq"], t["cb"], codec)
    table = k8.table_scores_reference(
        t["lists"], t["counts"], t["probe"], t["xq"], t["cents"], lut,
        _row_terms(t, codec), mask, metric).numpy()
    raw = k8.ivf_pq_scan_reference(
        t["lists"], t["counts"], t["probe"], t["xq"], t["cents"], t["cb"],
        mask, metric, codec).numpy()
    np.testing.assert_array_equal(np.isneginf(table), np.isneginf(raw))
    cn = (L["cents"] ** 2).sum(1)[L["probe"]].max(1)
    rho = float(k8.residual_bound(k8.codebook_norms(t["cb"]), codec))
    bound = k8.error_bound((L["xq"] ** 2).sum(1), cn, rho, d, m, metric)
    live = np.isfinite(raw)
    diff = np.abs(np.where(live, table, 0) - np.where(live, raw, 0))
    diff = diff.reshape(nq, -1)
    assert (diff <= bound[:, None]).all(), (diff.max(1), bound)


def test_residual_bound_bounds_every_row():
    """ρ bounds ‖res‖ of any code: PQ from the squared norms, RQ from the
    norms of each stage's largest entry."""
    rng = np.random.default_rng(4)
    for codec, dim in (("pq", 4), ("rq", 16)):
        cb = torch.from_numpy(rng.standard_normal((4, 16, dim)).astype(
            np.float32))
        codes = torch.from_numpy(rng.integers(0, 16, (500, 4)).astype(
            np.uint8))
        res = codec_decode(codes, cb, codec)
        rho = k8.residual_bound(k8.codebook_norms(cb), codec)
        assert (res.norm(dim=1) <= rho * (1 + 1e-6)).all()


def test_error_bound_and_margin():
    """E grows with the query, the centroids and ρ, and L2's exceeds the
    inner product's (squares of norms); m = max(16, k / 8)."""
    e_l2 = k8.error_bound(4.0, 9.0, 1.0, 128, 16, "L2")
    assert e_l2 == pytest.approx((4 * 128 + 32 + 16) * 2.0 ** -24 * 36 * 1.001)
    e_ip = k8.error_bound(4.0, 9.0, 1.0, 128, 16, "INNER_PRODUCT")
    assert e_ip == pytest.approx((2 * 128 + 32 + 8) * 2.0 ** -24 * 8 * 1.001)
    assert k8.error_bound(16.0, 9.0, 1.0, 128, 16, "L2") > e_l2
    assert k8.error_bound(4.0, 9.0, 2.0, 128, 16, "INNER_PRODUCT") > e_ip
    assert [k8.margin(k) for k in (1, 10, 128, 1000, 1024)] == \
        [16, 16, 16, 125, 128]


@pytest.mark.parametrize("nq,nprobe,k,m,ksub", [
    (64, 64, 10, 16, 256),       # PQ16 at b48, launched as 64 rows
    (1024, 64, 10, 16, 256),     # PQ16 at b1024
    (1024, 64, 10, 8, 256),      # RQ8x8 at b1024
    (48, 16, 100, 192, 256),     # d = 1536, dsub 8: the table in L2
    (1, 3, 1024, 384, 16),       # the largest k, a 4-bit table
    (4096, 4096, 1, 4, 16),      # more probes than a block takes
])
def test_plan_shapes(nq, nprobe, k, m, ksub):
    """Every probe slot in one split, splits of at most _PPS_MAX lists,
    enough blocks at small batches, shared memory within the card's, and
    slots that take a warp's pushes."""
    p = k8.plan(nq, nprobe, k, m, ksub, 132)
    k2 = p["k2"]
    assert k2 == k + k8.margin(k)
    assert p["splits"] * p["pps"] >= nprobe > (p["splits"] - 1) * p["pps"]
    assert p["pps"] <= 256
    assert nq * p["splits"] >= min(2 * 132, nq * nprobe)  # blocks an SM
    assert p["slots"] >= k2 + 32 and p["slots"] & (p["slots"] - 1) == 0
    assert p["smem_lut"] == (4 * m * ksub <= 64 * 1024)
    smem = (4 * m * ksub * p["smem_lut"] + 16 * p["pps"]
            + 8 * p["warps"] * p["slots"])
    assert 1 <= p["warps"] <= 8 and smem <= 227 * 1024
    ms = p["merge_slots"]
    assert ms >= max(2 * k2, k2 + 32) and ms & (ms - 1) == 0
    assert p["merge_warps"] * ms * 8 <= 64 * 1024


# --- the walk of the three launches ------------------------------------------

def _plain_and_walk(L, codec, metric, mask, k, n_sm):
    t = _tensors(L)
    args = [t[n] for n in ("lists", "counts", "row_pos", "cb", "cents",
                           "probe", "xq")] + [mask]
    kw = dict(k=k, metric=metric, codec=codec)
    before = k8.LAUNCHES
    plain = k8.ivf_pq_list_search(*args, **kw,
                                  row_terms=_row_terms(t, codec))
    assert k8.LAUNCHES == before                  # CPU: the plain version
    got = k8.walk(*args, **kw, row_terms=_row_terms(t, codec), n_sm=n_sm)
    return plain, got


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,m,nbits", CODECS)
def test_walk_matches_plain_and_jax(codec, m, nbits, metric, masked):
    """The walk on the kernels' plan (n_sm = 16: several splits a query)
    equals the plain search exactly with no query unproven, and agrees with
    the JAX package's interpreted gather path; tied rows of one list resolve
    to the lower storage row."""
    d, nq, nprobe, k = 16, 16, 4, 20
    L = _layout(5, codec, m, nbits, d, nq, nprobe)
    mask = torch.from_numpy(L["mask"]) if masked else None
    plain, (s, p, unproven) = _plain_and_walk(L, codec, metric, mask, k, 16)
    assert k8.plan(nq, nprobe, k, m, 1 << nbits, 16)["splits"] > 1
    assert unproven == 0
    assert torch.equal(s, plain[0]) and torch.equal(p, plain[1])
    want = pallas_ivf_pq_search(
        *(jnp.asarray(L[n]) for n in NAMES),
        None if mask is None else jnp.asarray(L["mask"]), k=k,
        nprobe=nprobe, metric=metric, q_chunk=8,
        precision=lax.Precision.HIGHEST, interpret=True, codec=codec)
    _assert_search_agrees((s, p), want, L["xq"])
    s, p = s.numpy(), p.numpy()
    list_of = np.searchsorted(np.cumsum(L["counts"]), p, side="right")
    tied = ((s[:, 1:] == s[:, :-1]) & np.isfinite(s[:, 1:])
            & (list_of[:, 1:] == list_of[:, :-1]))
    assert (p[:, 1:][tied] > p[:, :-1][tied]).all()


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["pq", "rq"])
def test_walk_ties_resolve_to_the_lower_row(codec, metric):
    """A query at the decoded row of slots 4 and 5 of the full list (equal
    codes): under L2 both are its best rows, tied, the lower storage row
    first, in the walk as in the plain search."""
    m = 4
    L = _layout(8, codec, m, 8, 16, 2, 4)
    row = codec_decode(torch.from_numpy(L["lists"][1, 4][None]),
                       torch.from_numpy(L["cb"]), codec).numpy()[0]
    L["xq"][0] = row + L["cents"][1]
    _put(L["probe"][0], 1, 2)
    plain, (s, p, unproven) = _plain_and_walk(L, codec, metric, None, 5, 4)
    assert unproven == 0
    assert torch.equal(s, plain[0]) and torch.equal(p, plain[1])
    if metric == "L2":
        first = L["row_pos"][1, 4]
        assert p[0, :2].tolist() == [first, first + 1]
        assert s[0, 0] == s[0, 1]


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["pq", "rq"])
def test_walk_best_rows_in_different_splits(codec, metric):
    """One query over eight lists, one split each: its best rows come from
    several splits and the merge keeps them all."""
    m = 4
    L = _layout(6, codec, m, 8, 16, 1, 8)
    k = 30
    assert k8.plan(1, 8, k, m, 256, 132)["splits"] == 8
    plain, (s, p, unproven) = _plain_and_walk(L, codec, metric, None, k, 132)
    assert unproven == 0
    assert torch.equal(s, plain[0]) and torch.equal(p, plain[1])
    lists_of = np.searchsorted(np.cumsum(L["counts"]), p.numpy()[0],
                               side="right")
    assert len(set(lists_of.tolist())) >= 2


@pytest.mark.parametrize("k", [1, 7, 300])
def test_walk_counts_and_widths(k):
    """k from 1 to beyond the probed rows: missing slots are (-inf, -1) as
    in the plain search, the result is (nq, k)."""
    L = _layout(7, "pq", 4, 8, 16, 8, 2)
    plain, (s, p, _) = _plain_and_walk(L, "pq", "L2", None, k, 4)
    assert s.shape == p.shape == (8, k)
    n = plain[0].shape[1]
    assert torch.equal(s[:, :n], plain[0]) and torch.equal(p[:, :n],
                                                           plain[1])
    assert torch.isneginf(s[:, n:]).all() and (p[:, n:] == -1).all()


# --- the index: row terms in the layout, the k limit -------------------------

def _clustered(seed, n, d=16, ncl=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 5
    return (centers[rng.integers(0, ncl, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.3)


@pytest.fixture
def pcat():
    prev = dt.config.device
    dt.set_device("cpu")
    yield dt.Catalog()
    dt.config.device = prev


def _assert_layout_row_terms(idx):
    lay = idx._build_device_layout()
    codes = lay.payload.reshape(-1, lay.payload.shape[2])
    res = codec_decode(codes, lay.codebooks.double(), idx.pq_codec).numpy()
    res = res.reshape(lay.payload.shape[0], lay.payload.shape[1], -1)
    cents = lay.centroids.double().numpy()[:, None, :]
    want = (res * res).sum(-1) + 2 * (cents * res).sum(-1)
    live = lay.row_pos.numpy() >= 0
    rt = lay.rt.numpy()
    assert (rt[~live] == 0).all()
    scale = ((res * res).sum(-1) + 2 * np.abs(cents * res).sum(-1)).max()
    np.testing.assert_allclose(rt[live], want[live], rtol=0,
                               atol=REL_TOL * scale)
    return lay


@pytest.mark.parametrize("factory", ["IVF4,PQ4", "IVF4,RQ2x4"])
def test_layout_row_terms_rebuilt_after_add(pcat, factory):
    """The L2 layout keeps each slot's row term, equal to float64 decoded
    rows; a faiss_add rebuilds it with the layout."""
    dt.faiss_create("rt", 16, factory, metric_type="L2", catalog=pcat)
    dt.faiss_add(_clustered(20, 800), "rt", catalog=pcat)
    idx = pcat.get("rt").index
    first = _assert_layout_row_terms(idx)
    dt.faiss_add(_clustered(21, 500), "rt", catalog=pcat)
    second = _assert_layout_row_terms(idx)
    assert int(second.counts.sum()) == 1300 == int(first.counts.sum()) + 500


def test_inner_product_layout_has_no_row_terms(pcat):
    dt.faiss_create("ip", 16, "IVF4,PQ4", metric_type="INNER_PRODUCT",
                    catalog=pcat)
    dt.faiss_add(_clustered(22, 800), "ip", catalog=pcat)
    assert pcat.get("ip").index._build_device_layout().rt is None


@pytest.mark.parametrize("factory", ["IVF4,PQ4", "IVF4,RQ2x4"])
def test_k_above_the_kernel_limit_takes_the_gather_path(pcat, factory):
    """k ≤ MAX_K takes K8 through the padded layout; above it the gather
    path serves (a shape rule), with the same best rows."""
    dt.faiss_create("big", 16, factory, metric_type="L2", catalog=pcat)
    dt.faiss_add(_clustered(23, 1500), "big", catalog=pcat)
    idx = pcat.get("big").index
    xq = _clustered(24, 4)
    params = {"nprobe": "4"}
    small = dt.faiss_search("big", 10, xq, params, catalog=pcat)
    assert idx._last_scan_path == "per-query"
    big = dt.faiss_search("big", k8.MAX_K + 1, xq, params, catalog=pcat)
    assert idx._last_scan_path == "gather"
    assert big["label"].shape == (4, k8.MAX_K + 1)
    at_limit = dt.faiss_search("big", k8.MAX_K, xq, params, catalog=pcat)
    assert idx._last_scan_path == "per-query"
    for res in (big, at_limit):
        d = res["distance"][:, :10]
        np.testing.assert_allclose(d, small["distance"], rtol=1e-5,
                                   atol=1e-5 * np.abs(d).max())
        apart = np.diff(small["distance"], axis=1) > 1e-4
        same = np.ones_like(apart[:, :1])
        sep = np.concatenate([same, apart], 1) & np.concatenate(
            [apart, same], 1)
        np.testing.assert_array_equal(res["label"][:, :10][sep],
                                      small["label"][sep])
