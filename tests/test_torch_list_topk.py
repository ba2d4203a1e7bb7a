"""The fused per-query list searches (K6 IVF,Flat and K2 IVF,SQ: a partial
launch over queries x splits whose consumer warps keep their best
candidates, and a merge launch) on the CPU.

The kernels run only on the card; here the plain walks of their own
algorithm (``ivf_list_scan.walk``, ``ivf_sq_scan.walk``: the plan's splits,
the chunks handed to each warp, the merge, K2's rescore) are held against

* the plain versions (``ivf_list_search`` / ``ivf_sq_list_search`` on CPU
  tensors: the raw score block, ``exact_topk``, the resolve, and for K2
  ``sq_exact_rerank``), exactly: the walks take the plain scores, and the
  ranking is a total order, so the plan may not change a result;
* the JAX package's ``pallas_ivf_search`` / ``pallas_ivf_sq_search`` with
  their Pallas kernels interpreted (as tests/test_torch_ivf_kernels.py and
  tests/test_torch_sq_kernels.py run them): K6 scores within 1e-5 of the
  batch's largest |score| (rtol 1e-5), positions equal where neighbouring
  scores are further apart than that; K2's k_scan candidates equal to the
  plain top-k_scan of the raw int8 scores exactly, its final distances
  within 1e-5 of the batch's largest, positions where apart.

Inputs are made from numpy with a seed.  The kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_faiss_ext_tpu.ops.pallas_ivf import (pallas_ivf_search,
                                                 pallas_ivf_sq_search)
from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
from duckdb_faiss_ext_tpu_torch.ops import list_topk as lt
from duckdb_faiss_ext_tpu_torch.ops import sq as psq
from duckdb_faiss_ext_tpu_torch.ops import sq_digits
from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk

NLIST, LMAX = 8, 128
METRICS = ("L2", "INNER_PRODUCT")
CODECS = ("sq8", "sq4", "sq6")
TOL = 1e-5
N_SM = 16       # a small card: several splits a query


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _counts(rng):
    counts = rng.integers(20, LMAX, NLIST).astype(np.int32)
    counts[1], counts[2] = LMAX, 0                   # a full and an empty list
    return counts


def _row_pos(counts):
    row_pos = np.full((NLIST, LMAX), -1, np.int32)
    start = 0
    for li, c in enumerate(counts):
        row_pos[li, :c] = np.arange(start, start + c)
        start += c
    return row_pos


def _probe(rng, nq, nprobe):
    probe = np.stack([rng.choice(NLIST, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    j = np.flatnonzero(probe[0] == 2)
    if j.size:
        probe[0, j[0]] = probe[0, 0]
    probe[0, 0] = 2                                  # the empty list
    return probe


def _flat(seed, nq, nprobe, d=24):
    """A padded (nlist, lmax, d) fp32 layout, its row positions, a probe
    table, queries and a mask."""
    rng = np.random.default_rng(seed)
    counts = _counts(rng)
    lists = np.zeros((NLIST, LMAX, d), np.float32)
    for li, c in enumerate(counts):
        lists[li, :c] = rng.standard_normal((c, d))
    return dict(lists=lists, counts=counts, row_pos=_row_pos(counts),
                probe=_probe(rng, nq, nprobe),
                xq=rng.standard_normal((nq, d)).astype(np.float32),
                mask=(rng.random((NLIST, LMAX)) < 0.6).astype(np.int8))


def _sq(seed, codec, nq, nprobe, d=32):
    """A padded (nlist, lmax, w) SQ code layout with its rn / rs, row
    positions, ranges, a probe table, queries and a mask."""
    rng = np.random.default_rng(seed)
    counts = _counts(rng)
    x = rng.standard_normal((int(counts.sum()), d)).astype(np.float32)
    vmin, scale = psq.sq_train(torch.from_numpy(x), psq.SQ_LEVELS[codec])
    codes = psq.sq_pack(psq.sq_quantize(torch.from_numpy(x), vmin, scale,
                                        psq.SQ_LEVELS[codec]).numpy(), codec)
    vmin, scale = vmin.numpy(), scale.numpy()
    row_pos = _row_pos(counts)
    valid = row_pos >= 0
    lists = np.zeros((NLIST, LMAX, codes.shape[1]), np.uint8)
    lists[valid] = codes[row_pos[valid]]
    rn = np.zeros((NLIST, LMAX), np.float32)
    rs = np.zeros((NLIST, LMAX), np.float32)
    rn[valid] = psq.sq_row_norms(codes, scale, d, codec)[row_pos[valid]]
    rs[valid] = psq.sq_row_sums(codes, d, codec)[row_pos[valid]]
    return dict(lists=lists, rn=rn, rs=rs, counts=counts, row_pos=row_pos,
                vmin=vmin, scale=scale, probe=_probe(rng, nq, nprobe),
                xq=rng.standard_normal((nq, d)).astype(np.float32),
                mask=(rng.random((NLIST, LMAX)) < 0.6).astype(np.int8))


def _flat_args(L, mask):
    return _t(L["lists"], L["counts"], L["row_pos"], L["probe"], L["xq"],
              mask)


def _sq_args(L, mask):
    return _t(L["lists"], L["rn"], L["rs"], L["counts"], L["row_pos"],
              L["probe"], L["xq"], mask, L["vmin"], L["scale"])


def _jax_sq_lists(lists, codec):
    """The JAX sq6 kernels' plane-major (nlist, 3·lmax, w/3) payload."""
    if codec != "sq6":
        return lists
    nlist, lmax, w = lists.shape
    return np.ascontiguousarray(
        lists.reshape(nlist, lmax, w // 3, 3).transpose(0, 3, 1, 2)
    ).reshape(nlist, 3 * lmax, w // 3)


def _assert_topk_agree(got, want):
    """Scores within TOL of the batch's largest |score| (rtol TOL),
    positions equal wherever neighbouring scores are further apart."""
    (gs, gp), (ws, wp) = (tuple(np.asarray(a) for a in pair)
                          for pair in (got, want))
    assert gs.shape == ws.shape
    finite = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), finite)
    np.testing.assert_array_equal(gp[~finite], wp[~finite])
    tol = TOL * (float(np.abs(ws[finite]).max()) if finite.any() else 1.0)
    np.testing.assert_allclose(gs[finite], ws[finite], rtol=TOL, atol=tol)
    gap = np.abs(np.diff(np.where(finite, ws, -1e30), axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(gp[sep], wp[sep])


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(
        got[1].to(torch.int32), want[1].to(torch.int32))


# --- K6: the walk against the plain search and the JAX package ---------------

@pytest.mark.parametrize("nprobe", [1, 3, 8])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_walk_matches_plain_and_jax(metric, masked, nprobe):
    """The walk on a plan of several splits equals the plain search, and
    both agree with the interpreted ``pallas_ivf_search``, for k = 1, 10
    and every slot (the -inf / -1 tail included)."""
    nq = 16
    L = _flat(nprobe, nq, nprobe)
    mask = L["mask"] if masked else None
    k_all = nprobe * LMAX
    ws, wp = (np.asarray(a) for a in pallas_ivf_search(
        *_j(L["lists"], L["counts"], L["row_pos"], L["probe"], L["xq"],
            mask), k=k_all, nprobe=nprobe, metric=metric, interpret=True))
    for k in (1, 10, k_all):
        if nprobe > 1:
            assert k6.plan(nq, nprobe, NLIST, LMAX, 24, k, N_SM)["splits"] > 1
        plain = k6.ivf_list_search(*_flat_args(L, mask), k=k, metric=metric)
        got = k6.walk(*_flat_args(L, mask), k=k, metric=metric, n_sm=N_SM)
        _assert_equal(got, plain)
        _assert_topk_agree(got, (ws[:, :k], wp[:, :k]))
    assert np.isneginf(ws[:, -1]).any()


# --- K2: the walk against the plain search and the JAX package ---------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_sq_walk_matches_plain_and_jax(codec, metric, masked):
    """The walk's k_scan candidates equal the plain top-k_scan of the raw
    int8 scores, its results equal the plain search, and both agree with
    the interpreted ``pallas_ivf_sq_search``."""
    nq, nprobe, k, k_scan = 16, 4, 10, 42
    L = _sq(30 + len(codec), codec, nq, nprobe)
    mask = L["mask"] if masked else None
    assert k2.plan(nq, nprobe, NLIST, LMAX, L["lists"].shape[2], 32, k,
                   k_scan, codec, N_SM)["splits"] > 1
    args = _sq_args(L, mask)
    kw = dict(k=k, k_scan=k_scan, metric=metric, codec=codec)
    s, p, cs, cf = k2.walk(*args, **kw, n_sm=N_SM)
    q = sq_digits.query_digits(*_t(L["xq"], L["vmin"], L["scale"]), metric,
                               codec, L["lists"].shape[2],
                               sq_digits.KERNEL_SHIFT[codec])
    raw = k2.ivf_sq_scan_reference(*args[:4], args[5], q.digits, q.scalars,
                                   args[7], metric, codec).reshape(nq, -1)
    bs, sel = exact_topk(raw, k_scan)
    assert torch.equal(cs, bs)
    fin = torch.isfinite(bs)
    assert torch.equal(cf[fin], sel[fin]) and (cf[~fin] == -1).all()
    _assert_equal((s, p), k2.ivf_sq_list_search(*args, **kw))
    want = pallas_ivf_sq_search(
        *_j(_jax_sq_lists(L["lists"], codec), L["rn"], L["rs"], L["counts"],
            L["row_pos"], L["vmin"], L["scale"], L["probe"], L["xq"], mask),
        k=k, k_scan=k_scan, nprobe=nprobe, metric=metric, codec=codec,
        interpret=True)
    _assert_topk_agree((s, p), want)


# --- ties whose rows lie in different splits ------------------------------

def _tie_probe(first, second):
    """One query probing every list, ``first`` before ``second``."""
    rest = [li for li in range(NLIST) if li not in (first, second)]
    return np.array([[first] + rest[:3] + [second] + rest[3:]], np.int32)


def _splits_of_slot7(L, order, p):
    """The splits of the partial launch that score slot 7 of the lists in
    ``order``."""
    part = lt.parts(*_t(L["counts"], L["probe"]), p).reshape(NLIST, LMAX)
    slot = {li: int(np.flatnonzero(L["probe"][0] == li)[0]) for li in order}
    return [int(part[slot[li], 7]) // p["warps"] for li in order]


@pytest.mark.parametrize("order", [(3, 5), (5, 3)])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_ties_across_splits(metric, order):
    """Slot 7 of lists 3 and 5 holds the same row, and the query is that
    row: under L2 the two are its best rows, tied, and the one of the
    earlier probe slot (the lower flat index, in another split) comes
    first whatever the storage rows; the walk equals the plain search."""
    L = _flat(41, 1, NLIST)
    L["lists"][5, 7] = L["lists"][3, 7]
    L["xq"][0] = L["lists"][3, 7]
    L["probe"] = _tie_probe(*order)
    p = k6.plan(1, NLIST, NLIST, LMAX, 24, 5, 132)
    first_split, second_split = _splits_of_slot7(L, order, p)
    assert first_split < second_split
    plain = k6.ivf_list_search(*_flat_args(L, None), k=5, metric=metric)
    got = k6.walk(*_flat_args(L, None), k=5, metric=metric, n_sm=132)
    _assert_equal(got, plain)
    if metric == "L2":
        first, second = (L["row_pos"][li, 7] for li in order)
        assert got[1][0, :2].tolist() == [first, second]
        assert got[0][0, 0] == got[0][0, 1] == 0


@pytest.mark.parametrize("order", [(3, 5), (5, 3)])
@pytest.mark.parametrize("codec", CODECS)
def test_sq_ties_across_splits(codec, order):
    """Slot 7 of lists 3 and 5 holds the same codes, and the query is their
    decoded row: under L2 both rerank to distance 0, tied, and the
    earlier probe slot's comes first (the int8 order, which is the flat
    order for equal rows); the walk equals the plain search."""
    L = _sq(42, codec, 1, NLIST)
    for name in ("lists", "rn", "rs"):
        L[name][5, 7] = L[name][3, 7]
    L["xq"][0] = psq.sq_decode(*_t(L["lists"][3, 7:8], L["vmin"],
                                   L["scale"]), codec).numpy()[0]
    L["probe"] = _tie_probe(*order)
    kw = dict(k=5, k_scan=33, metric="L2", codec=codec)
    plan = k2.plan(1, NLIST, NLIST, LMAX, L["lists"].shape[2], 32, 5, 33,
                   codec, 132)
    first_split, second_split = _splits_of_slot7(L, order, plan)
    assert first_split < second_split
    s, p, _, _ = k2.walk(*_sq_args(L, None), **kw, n_sm=132)
    _assert_equal((s, p), k2.ivf_sq_list_search(*_sq_args(L, None), **kw))
    first, second = (L["row_pos"][li, 7] for li in order)
    assert p[0, :2].tolist() == [first, second]
    assert s[0, 0] == s[0, 1] == 0


@pytest.mark.parametrize("kernel", ["k6", "k2"])
def test_one_list_shared_by_many_splits(kernel):
    """One query probing only the full list: its chunks are shared out
    among several splits, which start and end inside the list; the walk
    equals the plain search."""
    if kernel == "k6":
        L = _flat(43, 1, 1)
        L["probe"][0, 0] = 1
        p = k6.plan(1, 1, NLIST, LMAX, 24, 10, 132)
        got = k6.walk(*_flat_args(L, L["mask"]), k=10, metric="L2",
                      n_sm=132)
        want = k6.ivf_list_search(*_flat_args(L, L["mask"]), k=10,
                                  metric="L2")
    else:
        L = _sq(44, "sq4", 1, 1)
        L["probe"][0, 0] = 1
        p = k2.plan(1, 1, NLIST, LMAX, L["lists"].shape[2], 32, 10, 42,
                    "sq4", 132)
        kw = dict(k=10, k_scan=42, metric="INNER_PRODUCT", codec="sq4")
        got = k2.walk(*_sq_args(L, L["mask"]), **kw, n_sm=132)[:2]
        want = k2.ivf_sq_list_search(*_sq_args(L, L["mask"]), **kw)
    part = lt.parts(*_t(L["counts"], L["probe"]), p)[0]
    assert p["splits"] == 4 and len(set((part // p["warps"]).tolist())) > 1
    _assert_equal(got, want)


# --- the plan -------------------------------------------------------------

@pytest.mark.parametrize("kernel,nq,nprobe,lmax,width,k,k_scan", [
    ("k6", 64, 64, 1536, 128, 10, None),      # IVF4096 1M x 128, b48
    ("k6", 1024, 64, 1536, 128, 10, None),    # the same, b1024
    ("k6", 64, 16, 3584, 1536, 10, None),     # IVF1024 x 1536, b48
    ("k6", 1, 3, 256, 8, 1024, None),         # the largest k at d = 8
    ("k6", 4096, 1024, 16, 4, 1, None),       # more probes than a block takes
    ("k2", 64, 16, 1024, 1536, 10, 42),       # IVF4096,SQ8 2M x 1536, b48
    ("k2", 64, 16, 2560, 1536, 10, 42),       # the 8.8M device layout, b48
    ("k2", 48, 64, 1024, 1152, 256, 1024),    # sq6 at the largest k_scan
])
def test_plan_shapes(kernel, nq, nprobe, lmax, width, k, k_scan):
    """Splits (each an equal share of a query's chunks) giving two blocks
    an SM or more at small batches, at most four a probe slot, and one a
    query at b1024,
    chunks of at most 32 rows and 12 KB (one row where a row is larger) in
    16-byte stages with room for the rounding, stages a whole number for each consumer warp, shared memory
    within the card's, and list slots that take a warp's pushes."""
    if kernel == "k6":
        p = k6.plan(nq, nprobe, 4096, lmax, width, k, 132)
        row_bytes, k2_ = 4 * width, k
    else:
        p = k2.plan(nq, nprobe, 4096, lmax, width, 1536, k, k_scan, "sq8",
                    132)
        row_bytes, k2_ = width, min(k_scan, nprobe * lmax)
    assert p["k2"] == k2_ and p["row_bytes"] == row_bytes
    assert 1 <= p["splits"] <= 4 * nprobe
    assert nq * p["splits"] >= min(2 * 132, 4 * nq * nprobe)  # blocks an SM
    if nq >= 1024:
        assert p["splits"] == 1
    cr = p["chunk_rows"]
    assert 1 <= cr <= 32 and (cr == 1 or cr * row_bytes <= 12 * 1024)
    assert cr == 32 or (cr + 1) * row_bytes > 12 * 1024
    assert p["stage_bytes"] % 16 == 0
    assert p["stage_bytes"] >= cr * row_bytes + 32
    assert p["stages"] % p["warps"] == 0 and p["warps"] >= 1
    extra = 4 * width if kernel == "k6" else 2 * sq_digits.digit_width(
        width, "sq8")
    assert p["smem"] == lt.partial_smem(p["stages"], p["stage_bytes"],
                                        p["warps"], p["slots"], extra)
    assert p["smem"] <= 227 * 1024
    assert p["slots"] >= k2_ + 32 and p["slots"] & (p["slots"] - 1) == 0
    ms = p["merge_slots"]
    assert ms >= max(2 * k2_, k2_ + 32) and ms & (ms - 1) == 0
    assert len(lt.PLAN_FIELDS) == 18 and set(lt.PLAN_FIELDS) <= set(p)


# --- routing: the k limit, the CPU, no fallback ----------------------------

def _meta(t):
    return t.to("meta")


@pytest.mark.parametrize("k,route", [(k6.MAX_K, "ivf_list_search"),
                                     (k6.MAX_K + 1, "ivf_list_scan")])
def test_flat_route_above_the_k_limit(k, route):
    """Off the CPU, k <= MAX_K takes the fused search and k above it the
    raw launch (then exact_topk and the resolve): each checks its inputs
    under its own name before anything runs."""
    L = _flat(51, 4, 2)
    args = _flat_args(L, None)
    args[0] = _meta(args[0])
    with pytest.raises(ValueError, match=f"^{route}: every tensor"):
        k6.ivf_list_search(*args, k=k, metric="L2")


@pytest.mark.parametrize("k_scan,route", [(k2.MAX_K, "ivf_sq_list_search"),
                                          (k2.MAX_K + 1, "ivf_sq_scan")])
def test_sq_route_above_the_k_limit(k_scan, route):
    """Off the CPU, k_scan <= MAX_K takes the fused search, and above it
    the raw launch with the torch top-k_scan and ``sq_exact_rerank``; the
    limit counts k_scan as the probed slots cap it."""
    L = _sq(52, "sq8", 4, NLIST)
    args = _sq_args(L, None)
    # lists of 256 slots: 8 probes cap k_scan at 2048
    args[0] = torch.empty((NLIST, 2 * LMAX, L["lists"].shape[2]),
                          dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match=f"^{route}: every tensor"):
        k2.ivf_sq_list_search(*args, k=10, k_scan=k_scan, metric="L2",
                              codec="sq8")


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """CPU tensors take the plain versions: no launch is counted, and the
    results are the plain searches'."""
    F = _flat(53, 4, 2)
    S = _sq(54, "sq4", 4, 2)
    before = (k6.LAUNCHES, k6.TOPK_LAUNCHES, k2.LAUNCHES, k2.TOPK_LAUNCHES)
    got6 = k6.ivf_list_search(*_flat_args(F, None), k=5, metric="L2")
    _assert_equal(got6, k6.ivf_list_search_reference(*_flat_args(F, None),
                                                     k=5, metric="L2"))
    kw = dict(k=5, k_scan=40, metric="INNER_PRODUCT", codec="sq4")
    got2 = k2.ivf_sq_list_search(*_sq_args(S, S["mask"]), **kw)
    _assert_equal(got2, k2.ivf_sq_list_search_reference(
        *_sq_args(S, S["mask"]), **kw))
    assert (k6.LAUNCHES, k6.TOPK_LAUNCHES, k2.LAUNCHES,
            k2.TOPK_LAUNCHES) == before


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4])
def test_flat_search_never_falls_back_off_the_cpu(which):
    """Any one of lists, counts, row_pos, probe_ids, xq on a device the
    kernels cannot launch on raises before any score is computed."""
    args = _flat_args(_flat(55, 4, 2), None)
    args[which] = _meta(args[which])
    before = (k6.LAUNCHES, k6.TOPK_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        k6.ivf_list_search(*args, k=5, metric="L2")
    assert (k6.LAUNCHES, k6.TOPK_LAUNCHES) == before


@pytest.mark.parametrize("which", [0, 1, 3, 4, 5])
def test_sq_search_never_falls_back_off_the_cpu(which):
    """Any one of codes, rn, counts, row_pos, probe_ids on a device the
    kernels cannot launch on raises before any score is computed."""
    args = _sq_args(_sq(56, "sq8", 4, 2), None)
    args[which] = _meta(args[which])
    before = (k2.LAUNCHES, k2.TOPK_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        k2.ivf_sq_list_search(*args, k=5, k_scan=20, metric="L2",
                              codec="sq8")
    assert (k2.LAUNCHES, k2.TOPK_LAUNCHES) == before
