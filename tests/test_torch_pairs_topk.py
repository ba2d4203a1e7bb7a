"""The fused pair-tile IVF,Flat search (K7 / K10: a partial launch over work
items, each a run of up to T tiles of one list times a share of its live
rows, whose query slots keep their best k_scan candidates, and a merge
launch that rescores the pool in fp32) on the CPU.

The kernels run only on the card; here the plain walk of their own
algorithm (``ivf_pairs.walk``: ``plan``'s shapes, the item table
``pair_items`` builds, each (pair, share) list's best k_scan, the merge,
the rescore) is held against

* the JAX package's ``pallas_ivf_pairs_search`` with its Pallas kernel
  interpreted, on the grid and on the mega-step branch (as
  tests/test_torch_ivf_kernels.py and tests/test_torch_mega_kernels.py run
  them), on the same padded layout, probe table and queries made from
  numpy with a seed: labels (positions) equal wherever neighbouring
  distances are further apart than the tolerance, distances within 1e-5
  of the batch's largest |distance| (rtol 1e-5; fp32 sums taken in
  another order by the two packages);
* the port's plain version (``ivf_pairs_search`` on CPU tensors: the raw
  tiles' plain version and ``pairs_flat_epilogue``), exactly: the walk
  takes the plain scores and the ranking is a total order, so the items
  may not change a result.

The shares are cut at ``SHARE_ROWS``; some cases lower it to 128 rows (a
multiple of the kernels' row tile) so that small lists span several
shares.  The kernels themselves are held against the plain version on the
card by chip_smoke.py and the ``gpu``-marked cases of
tests/test_torch_package.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_faiss_ext_tpu.ops.pallas_ivf_pairs import pallas_ivf_pairs_search
from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10

NLIST, LMAX, D = 8, 256, 24
METRICS = ("L2", "INNER_PRODUCT")


def _layout(seed, nq, nprobe, *, lmax=LMAX, nlist=NLIST):
    """A padded (nlist, lmax, d) layout with one list at count == lmax, one
    empty list and equal rows (slots 4 and 5 of every list), its row
    positions, a probe table (query 0 probes the empty list first) and
    queries; query 2 sits on list 1's slot 4 and probes list 1 first."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(20, lmax, nlist).astype(np.int32)
    counts[1], counts[2] = lmax, 0
    lists = np.zeros((nlist, lmax, D), np.float32)
    row_pos = np.full((nlist, lmax), -1, np.int32)
    start = 0
    for li, c in enumerate(counts):
        lists[li, :c] = rng.standard_normal((c, D))
        row_pos[li, :c] = np.arange(start, start + c)
        start += c
    lists[:, 5] = lists[:, 4]
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    probe[0, 0] = 2
    probe[2] = np.concatenate([[1], [li for li in range(nlist)
                                     if li != 1][:nprobe - 1]])
    xq = rng.standard_normal((nq, D)).astype(np.float32)
    xq[2] = lists[1, 4]
    mask = (rng.random((nlist, lmax)) < 0.6).astype(np.int8)
    mask[:, 4:6] = 1
    return lists, counts, row_pos, probe, xq, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _k_scan(k, nprobe, lmax=LMAX):
    """k_scan as the IVF,Flat index picks it (models/ivf_serve.py)."""
    return min(nprobe * lmax, max(4 * k, k + 32))


def _assert_topk_agree(got, want):
    (gs, gp), (ws, wp) = (tuple(np.asarray(a) for a in pair)
                          for pair in (got, want))
    assert gs.shape == ws.shape
    finite = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), finite)
    np.testing.assert_array_equal(gp[~finite], wp[~finite])
    scale = float(np.abs(ws[finite]).max()) if finite.any() else 1.0
    tol = 1e-5 * scale
    np.testing.assert_allclose(gs[finite], ws[finite], rtol=1e-5, atol=tol)
    ext = np.where(finite, ws, -1e30)
    gap = np.abs(np.diff(ext, axis=1)) > 2 * tol
    separated = finite.copy()
    separated[:, 1:] &= gap
    separated[:, :-1] &= gap
    np.testing.assert_array_equal(gp[separated], wp[separated])


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].to(torch.int32), want[1].to(torch.int32))


@pytest.fixture
def small_shares(monkeypatch):
    """Shares of one 128-row tile, so that a 256-row list has two."""
    monkeypatch.setattr(k7, "SHARE_ROWS", 128)


# --- the walk against the JAX package and the plain version -----------------

@pytest.mark.parametrize("mega", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_walk_matches_jax(small_shares, metric, masked, k, mega):
    """The walk of the fused search (K7's and K10's items) against the
    interpreted Pallas pair kernel and its epilogue, on the grid and the
    mega-step branch, and exactly against the plain version (the grid or
    mega route on CPU tensors); dead slots in partial tiles, an empty
    list, a full one, and lists of two shares."""
    nq, nprobe = 40, 3
    lists, counts, row_pos, probe, xq, mask = _layout(7, nq, nprobe)
    mask = mask if masked else None
    k_scan = _k_scan(k, nprobe)
    ws, wp = pallas_ivf_pairs_search(
        jnp.asarray(lists), jnp.asarray(counts), jnp.asarray(row_pos),
        jnp.asarray(probe), jnp.asarray(xq),
        None if mask is None else jnp.asarray(mask), k=k, k_scan=k_scan,
        nprobe=nprobe, metric=metric, interpret=True, mega=mega)
    args = _t(lists, counts, row_pos, probe, xq, mask)
    got = k7.walk(*args, k=k, k_scan=k_scan, metric=metric)
    _assert_topk_agree(got, (ws, wp))
    _assert_equal(got, k7.ivf_pairs_search(*args, k=k, k_scan=k_scan,
                                           metric=metric, mega=mega))


@pytest.mark.parametrize("metric", METRICS)
def test_list_probed_by_more_queries_than_an_item_holds(metric):
    """Every query probes list 3: its 100 pairs make four runs of up to 32
    (4 tiles of 8 queries) each; the walk over those items equals the
    plain search."""
    nq, nprobe = 100, 2
    lists, counts, row_pos, probe, xq, mask = _layout(11, nq, nprobe)
    probe[:, 0] = 3
    probe[:, 1] = np.where(probe[:, 1] == 3, 4, probe[:, 1])
    args = _t(lists, counts, row_pos, probe, xq, mask)
    p = k7.plan(nq, nprobe, NLIST, LMAX, D, 10, 42, metric)
    first, npairs, lid, _ = k7.items_of(k7.pair_items(args[3], args[1], p),
                                        args[1], p)
    assert p["tiles"] == 4
    assert npairs[lid == 3].tolist() == [32, 32, 32, 4]
    got = k7.walk(*args, k=10, k_scan=42, metric=metric)
    _assert_equal(got, k7.ivf_pairs_search(*args, k=10, k_scan=42,
                                           metric=metric))


@pytest.mark.parametrize("metric", METRICS)
def test_long_list_cut_into_shares(metric):
    """A list of 1100 rows (lmax 1100) is three shares of up to 512 rows,
    each its own item; the walk equals the plain search, k_scan both below
    and above a share's rows."""
    nq, nprobe, lmax = 24, 3, 1100
    lists, counts, row_pos, probe, xq, mask = _layout(13, nq, nprobe,
                                                      lmax=lmax)
    args = _t(lists, counts, row_pos, probe, xq, mask)
    p = k7.plan(nq, nprobe, NLIST, lmax, D, 10, 42, metric)
    _, _, lid, share = k7.items_of(k7.pair_items(args[3], args[1], p),
                                   args[1], p)
    assert p["shares"] == 3
    assert sorted(set(share[lid == 1].tolist())) == [0, 1, 2]
    for k, k_scan in ((10, 42), (256, 1024)):
        got = k7.walk(*args, k=k, k_scan=k_scan, metric=metric)
        _assert_equal(got, k7.ivf_pairs_search(*args, k=k, k_scan=k_scan,
                                               metric=metric))


@pytest.mark.parametrize("k", [2, 10])
def test_equal_rows_come_out_in_flat_order(small_shares, k):
    """Query 2 sits on list 1's slots 4 and 5 (equal rows) and on slot 200
    (a third copy, in the list's second share): under L2 the three tie at
    distance 0 and come out by flat index, in the walk as in the plain
    search."""
    nq, nprobe = 16, 3
    lists, counts, row_pos, probe, xq, mask = _layout(17, nq, nprobe)
    lists[1, 200] = lists[1, 4]
    mask[1, 200] = 1
    args = _t(lists, counts, row_pos, probe, xq, mask)
    s, p = k7.walk(*args, k=k, k_scan=_k_scan(k, nprobe), metric="L2")
    want = [row_pos[1, 4], row_pos[1, 5], row_pos[1, 200]][:k]
    assert p[2, :len(want)].tolist() == want
    assert (s[2, :len(want)] == 0).all()
    _assert_equal((s, p), k7.ivf_pairs_search(
        *args, k=k, k_scan=_k_scan(k, nprobe), metric="L2"))


# --- the plan, the tables and the routes -------------------------------------

def test_plan_shapes():
    """T = 4 (32 queries) at k_scan 42 with K7's 3-stage ring and K10's
    deepest ring that keeps two blocks on an SM, both two blocks to an SM;
    T = 1 at k_scan 1024, K10 one block to an SM; the items of any probe
    table stay within the plan's bound; every block fits 227 KB."""
    p = k7.plan(1024, 16, 1024, 3584, 1536, 10, 42, "INNER_PRODUCT")
    assert (p["tiles"], p["stages"], p["slots"], p["shares"]) == (4, 3, 128, 7)
    assert p["items"] == (1024 * 16 // 32 + 1024) * 7
    assert 2 * (p["smem"] + 1024) <= 228 * 1024
    assert (p["merge_slots"], p["merge_warps"]) == (128, 8)
    m = k7.plan(1024, 16, 1024, 3584, 1536, 10, 42, "INNER_PRODUCT",
                mega=True, tma=True, vec4=True)
    assert (m["tiles"], m["stages"], m["tma"], m["vec4"]) == (4, 3, 1, 1)
    assert 2 * (m["smem"] + 1024) <= 228 * 1024
    big = k7.plan(64, 16, 1024, 3584, 1536, 256, 1024, "L2", mega=True)
    assert (big["tiles"], big["k2"], big["slots"], big["l2"]) == (1, 1024,
                                                                  2048, 1)
    assert big["stages"] >= 2 and 2 * (big["smem"] + 1024) > 228 * 1024
    for q in (p, m, big):
        assert q["smem"] <= 227 * 1024 and q["merge_smem"] <= 96 * 1024
        assert q["merge_slots"] >= max(2 * q["k2"], q["k2"] + 32)
    assert k7.plan(4, 2, 8, 16, 8, 5, 400, "L2")["k2"] == 32


@pytest.mark.parametrize("seed,nq,nprobe,lmax,skew", [
    (1, 40, 3, 256, False), (2, 100, 8, 1100, True), (3, 1, 1, 128, False),
    (4, 33, 5, 512, True)])
def test_items_cover_every_pair_share_once(seed, nq, nprobe, lmax, skew):
    """The item tables: ``order`` is build_pair_tiles' stable sort (the
    tiles' queries read in it); the item count stays within ``plan``'s
    bound, each item is a run of at most 8T consecutive sorted pairs of
    one list, starting at a multiple of 8T within the list, times one share
    below the list's count; and the items cover each (pair, share) of a
    non-empty list exactly once."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, lmax + 1, NLIST).astype(np.int32)
    counts[0] = lmax
    probe = np.stack([rng.choice(NLIST, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    if skew:
        probe[:, 0] = 0
    p = k7.plan(nq, nprobe, NLIST, lmax, D, 10, 42, "L2")
    tables = k7.pair_items(torch.from_numpy(probe), torch.from_numpy(counts),
                           p)
    order, ends, _, head = tables
    assert head.tolist() == [0, 0, 0, 0]
    t_max = k7.pairs_t_max(nq, nprobe, NLIST)
    tq = k7.build_pair_tiles(torch.from_numpy(probe), nlist=NLIST,
                             t_max=t_max)[1].numpy()
    assert (order // nprobe).tolist() == tq[tq >= 0].tolist()
    first, npairs, lid, share = (t.numpy() for t in k7.items_of(
        tables, torch.from_numpy(counts), p))
    assert len(first) == int(ends[1, -1]) and 0 < len(first) <= p["items"]
    width = k7.QG * p["tiles"]
    starts = np.concatenate([[0], ends[0].numpy()[:-1]])
    got = []
    for f, n, li, sh in zip(first, npairs, lid, share):
        assert 1 <= n <= width and (f - starts[li]) % width == 0
        assert sh * p["share_rows"] < counts[li]
        for pair in order[f:f + n].tolist():
            assert probe.reshape(-1)[pair] == li
            got.append((pair, int(sh)))
    want = [(q * nprobe + j, s) for q in range(nq) for j in range(nprobe)
            for s in range(-(-int(counts[probe[q, j]]) // p["share_rows"]))]
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("mega", [False, True])
@pytest.mark.parametrize("k_scan,route", [
    (k7.MAX_K_SCAN, "ivf_pairs_search"), (k7.MAX_K_SCAN + 1, None)])
def test_route_above_the_k_scan_limit(mega, k_scan, route):
    """Off the CPU, k_scan <= MAX_K_SCAN (as the probed slots cap it) takes
    the fused search and above it the raw launch (K7's, or K10's under
    mega) with the plain epilogue: each checks its inputs and raises on
    these, which lie on no CUDA device."""
    lists, counts, row_pos, probe, xq, _ = _layout(19, 8, 5)
    args = _t(lists, counts, row_pos, probe, xq, None)
    args[0] = torch.empty((NLIST, 4 * LMAX, D), device="meta")
    args[2] = torch.empty((NLIST, 4 * LMAX), dtype=torch.int32,
                          device="meta")
    route = route or ("ivf_pairs_mega_scan" if mega else "ivf_pairs_scan")
    with pytest.raises(ValueError, match=f"^{route}: every tensor"):
        k7.ivf_pairs_search(*args, k=10, k_scan=k_scan, metric="L2",
                            mega=mega)


def _counters():
    return (k7.LAUNCHES, k7.TOPK_LAUNCHES, k10.LAUNCHES, k10.TOPK_LAUNCHES)


@pytest.mark.parametrize("mega", [False, True])
def test_cpu_tensors_take_the_plain_version(mega):
    """CPU tensors take the plain version: no launch is counted, and the
    results are the plain search's."""
    lists, counts, row_pos, probe, xq, mask = _layout(23, 12, 3)
    args = _t(lists, counts, row_pos, probe, xq, mask)
    before = _counters()
    got = k7.ivf_pairs_search(*args, k=5, k_scan=40, metric="INNER_PRODUCT",
                              mega=mega)
    _assert_equal(got, k7.ivf_pairs_search_reference(
        *args, k=5, k_scan=40, metric="INNER_PRODUCT"))
    assert _counters() == before


@pytest.mark.parametrize("mega", [False, True])
@pytest.mark.parametrize("which", [0, 1, 2, 3, 4])
def test_search_never_falls_back_off_the_cpu(mega, which):
    """Any one of lists, counts, row_pos, probe_ids, xq on a device the
    kernels cannot launch on raises before any score is computed."""
    args = _t(*_layout(29, 12, 3)[:5]) + [None]
    args[which] = args[which].to("meta")
    before = _counters()
    with pytest.raises(ValueError, match="CUDA device"):
        k7.ivf_pairs_search(*args, k=5, k_scan=40, metric="L2", mega=mega)
    assert _counters() == before
