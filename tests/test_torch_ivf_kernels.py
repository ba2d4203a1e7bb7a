"""The port's IVF,Flat kernels (K6, K7) and the ops around them against the
JAX package's.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs the Pallas kernels ``pallas_ivf_search`` and
``pallas_ivf_pairs_search`` in interpret mode (as tests/test_ivf.py and
tests/test_pallas_pairs.py run them), on the same padded layout, probe
table and queries, made from numpy with a seed.

Tolerance: scores rtol=1e-5 with atol=1e-5·max|score| (fp32 sums taken in
another order by the two packages); positions equal wherever the
neighbouring scores are further apart than that, since two candidates
whose scores differ by less than the summation noise may swap ranks.
Integer ops (tile tables, probe ids) are held to exact equality.  The CUDA
kernels themselves are held against these plain versions on the card
(chip_smoke.py, and the ``gpu``-marked cases in
tests/test_torch_package.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_faiss_ext_tpu.models.ivf import _coarse_topk as jax_coarse
from duckdb_faiss_ext_tpu.ops import ivf_scan as jax_scan
from duckdb_faiss_ext_tpu.ops import pairs_gate as jax_gate
from duckdb_faiss_ext_tpu.ops.pallas_ivf import choose_lmax as jax_lmax
from duckdb_faiss_ext_tpu.ops.pallas_ivf import pallas_ivf_search
from duckdb_faiss_ext_tpu.ops.pallas_ivf_pairs import (
    build_pair_tiles as jax_tiles)
from duckdb_faiss_ext_tpu.ops.pallas_ivf_pairs import (
    pairs_t_max as jax_t_max)
from duckdb_faiss_ext_tpu.ops.pallas_ivf_pairs import pallas_ivf_pairs_search
from duckdb_faiss_ext_tpu_torch.factory import build_index
from duckdb_faiss_ext_tpu_torch.metrics import resolve_metric
from duckdb_faiss_ext_tpu_torch.models.ivf_layout import choose_lmax
from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
from duckdb_faiss_ext_tpu_torch.ops import ivf_scan
from duckdb_faiss_ext_tpu_torch.utils.config import config

NLIST, LMAX, D = 8, 128, 24


def _layout(seed, nq, nprobe, *, full_list=True, empty_list=True):
    """A padded (nlist, lmax, d) layout with one list at count == lmax and
    one empty list, its row positions, a probe table and queries."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(20, LMAX, NLIST).astype(np.int32)
    if full_list:
        counts[1] = LMAX
    if empty_list:
        counts[2] = 0
    lists = np.zeros((NLIST, LMAX, D), np.float32)
    row_pos = np.full((NLIST, LMAX), -1, np.int32)
    start = 0
    for li, c in enumerate(counts):
        lists[li, :c] = rng.standard_normal((c, D))
        row_pos[li, :c] = np.arange(start, start + c)
        start += c
    probe = np.stack([rng.choice(NLIST, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    probe[0, 0] = 2                                  # the empty list
    xq = rng.standard_normal((nq, D)).astype(np.float32)
    mask = (rng.random((NLIST, LMAX)) < 0.6).astype(np.int8)
    return lists, counts, row_pos, probe, xq, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


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


# --- K6: per-query list scan -------------------------------------------------

@pytest.mark.parametrize("nprobe", [1, 3, 8])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_list_scan_matches_jax_kernel(metric, masked, nprobe):
    """K6's plain version + top-k + position resolve against the
    interpreted Pallas kernel, for k = 1, 10 and k beyond the valid
    candidates (every slot: the -inf / -1 tail included)."""
    nq = 16
    lists, counts, row_pos, probe, xq, mask = _layout(nprobe, nq, nprobe)
    mask = mask if masked else None
    k_all = nprobe * LMAX
    ws, wp = pallas_ivf_search(
        jnp.asarray(lists), jnp.asarray(counts), jnp.asarray(row_pos),
        jnp.asarray(probe), jnp.asarray(xq),
        None if mask is None else jnp.asarray(mask),
        k=k_all, nprobe=nprobe, metric=metric, interpret=True)
    ws, wp = np.asarray(ws), np.asarray(wp)
    assert np.isneginf(ws[:, -1]).any()          # k beyond the valid rows
    for k in (1, 10, k_all):
        got = k6.ivf_list_search(*_t(lists, counts, row_pos, probe, xq, mask),
                                 k=k, metric=metric)
        _assert_topk_agree(got, (ws[:, :k], wp[:, :k]))


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_list_scan_raw_scores(metric):
    """The raw (nq, nprobe, lmax) block: -inf exactly at and beyond each
    list's count and on masked slots; the difference-form L2 / dot
    elsewhere."""
    lists, counts, row_pos, probe, xq, mask = _layout(5, 6, 4)
    raw = k6.ivf_list_scan(*_t(lists, counts, probe, xq, mask),
                           metric=metric).numpy()
    for i in range(6):
        for j in range(4):
            li = probe[i, j]
            valid = (np.arange(LMAX) < counts[li]) & (mask[li] != 0)
            x = lists[li].astype(np.float64)
            want = (x @ xq[i] if metric == "INNER_PRODUCT"
                    else -((x - xq[i]) ** 2).sum(1))
            np.testing.assert_array_equal(np.isneginf(raw[i, j]), ~valid)
            np.testing.assert_allclose(raw[i, j][valid], want[valid],
                                       rtol=1e-5, atol=1e-4)


# --- K7: pair-tile scan --------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_pairs_scan_matches_jax_kernel(metric, masked):
    """K7's plain version + epilogue against the interpreted Pallas pair
    kernel, with dead slots in partial tiles and n_tiles < t_max."""
    nq, nprobe, k = 16, 4, 7
    lists, counts, row_pos, probe, xq, mask = _layout(11, nq, nprobe)
    mask = mask if masked else None
    ws, wp = pallas_ivf_pairs_search(
        jnp.asarray(lists), jnp.asarray(counts), jnp.asarray(row_pos),
        jnp.asarray(probe), jnp.asarray(xq),
        None if mask is None else jnp.asarray(mask),
        k=k, k_scan=4 * k, nprobe=nprobe, metric=metric, interpret=True)
    got = k7.ivf_pairs_search(*_t(lists, counts, row_pos, probe, xq, mask),
                              k=k, k_scan=4 * k, metric=metric)
    _assert_topk_agree(got, (ws, wp))


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_pairs_raw_tiles(metric):
    """The raw tiles: real tiles scored in expansion form with -inf on dead
    slots, rows at or beyond the count and masked rows."""
    nq, nprobe = 10, 3
    lists, counts, _, probe, xq, mask = _layout(3, nq, nprobe)
    xq_t, qs_t, meta, _ = k7.pair_tile_inputs(torch.from_numpy(probe),
                                              torch.from_numpy(xq), NLIST)
    n_tiles, tl = int(meta[0]), meta[1:].numpy()
    assert 0 < n_tiles < xq_t.shape[0]
    assert xq_t.shape[0] % k7.TILE_ROUND == 0
    _, tq, _, _ = k7.build_pair_tiles(torch.from_numpy(probe), nlist=NLIST,
                                      t_max=xq_t.shape[0])
    raw = k7.ivf_pairs_scan(*_t(lists, counts), xq_t, qs_t, meta,
                            torch.from_numpy(mask), metric).numpy()
    tq = tq.numpy()
    for t in range(n_tiles):
        li = tl[t]
        x = lists[li].astype(np.float64)
        valid = (np.arange(LMAX) < counts[li]) & (mask[li] != 0)
        for s in range(k7.QG):
            row = raw[t, s]
            if tq[t, s] < 0:
                assert np.isneginf(row).all()
                continue
            q = xq[tq[t, s]].astype(np.float64)
            want = (x @ q if metric == "INNER_PRODUCT"
                    else -np.maximum(q @ q - 2 * x @ q + (x * x).sum(1), 0))
            np.testing.assert_array_equal(np.isneginf(row), ~valid)
            np.testing.assert_allclose(row[valid], want[valid], rtol=1e-5,
                                       atol=1e-4)


@pytest.mark.parametrize("nq,nprobe,nlist,skew", [
    (33, 5, 16, False), (64, 3, 8, True), (1, 1, 4, False)])
def test_build_pair_tiles_equals_jax(nq, nprobe, nlist, skew):
    """Every output of the tile table, integer-equal to the JAX one."""
    rng = np.random.default_rng(nq)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    if skew:
        probe[:, 0] = 0                          # one hot list
    t_max = k7.pairs_t_max(nq, nprobe, nlist)
    assert t_max == jax_t_max(nq, nprobe, nlist)
    got = k7.build_pair_tiles(torch.from_numpy(probe), nlist=nlist,
                              t_max=t_max)
    want = jax_tiles(jnp.asarray(probe), nlist=nlist, t_max=t_max)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- the plain ops around the kernels -----------------------------------------

@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_coarse_topk_equals_jax(metric):
    """Top-nprobe list ids, with exactly tied centroids resolving to the
    lower list id as lax.top_k does."""
    rng = np.random.default_rng(9)
    cents = rng.integers(-3, 4, (32, 8)).astype(np.float32)
    cents[20] = cents[4]                         # an exact tie
    xq = rng.integers(-3, 4, (12, 8)).astype(np.float32)
    xq[0] = cents[4]
    got = ivf_scan.coarse_topk(torch.from_numpy(xq), torch.from_numpy(cents),
                               6, metric)
    want = jax_coarse(jnp.asarray(xq), jnp.asarray(cents), jnp.float32(0.0),
                      nprobe=6, metric=metric, precision=None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", ["L2", "L1"])
def test_gather_scan_equals_jax(metric):
    """The sorted+gather scan over one row-sorted buffer, with a mask."""
    rng = np.random.default_rng(21)
    n, nlist, lmax, k = 600, 6, 256, 9
    assign = np.sort(rng.integers(0, nlist, n))
    counts = np.bincount(assign, minlength=nlist).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int32)
    xb = np.zeros((1024, 8), np.float32)
    xb[:n] = rng.standard_normal((n, 8))
    cents = rng.standard_normal((nlist, 8)).astype(np.float32)
    xq = rng.standard_normal((8, 8)).astype(np.float32)
    mask = rng.random(1024) < 0.7
    got = ivf_scan.ivf_search(
        *_t(xb, offs, counts, cents, xq, mask), 0.0, k=k, nprobe=3,
        metric=metric, q_chunk=4, lmax=lmax)
    want = jax_scan.ivf_search(
        *(jnp.asarray(a) for a in (xb, offs, counts, cents, xq, mask)),
        jnp.float32(0.0), k=k, nprobe=3, metric=metric, q_chunk=4,
        precision=None, lmax=lmax)
    _assert_topk_agree(got, want)


@pytest.mark.parametrize("nprobe", [2, 40])
def test_spill_scan_equals_jax(nprobe):
    """The dense spill scan, masked to each query's probes (2 and 40 of
    48 lists) and a row mask, then merged with a second candidate set."""
    rng = np.random.default_rng(nprobe)
    nlist, s_pad, n_real, k = 48, 256, 200, 6
    payload = rng.standard_normal((s_pad, 8)).astype(np.float32)
    assign = rng.integers(0, nlist, s_pad).astype(np.int32)
    pos = np.where(np.arange(s_pad) < n_real,
                   rng.permutation(5000)[:s_pad], -1).astype(np.int32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(8)]).astype(np.int32)
    xq = rng.standard_normal((8, 8)).astype(np.float32)
    mask = rng.random(s_pad) < 0.8
    got = ivf_scan.ivf_spill_scan(*_t(payload, assign, pos, probe, xq, mask),
                                  0.0, k=k, metric="L2", nlist=nlist)
    want = jax_scan.ivf_spill_scan(
        *(jnp.asarray(a) for a in (payload, assign, pos)),
        jnp.zeros((nlist, 8)), None, jnp.asarray(probe), jnp.asarray(xq),
        jnp.asarray(mask), jnp.float32(0.0), k=k, metric="L2",
        precision=None)
    _assert_topk_agree(got, want)
    other = (rng.standard_normal((8, k)).astype(np.float32) * 40 - 60,
             rng.integers(0, 100, (8, k)).astype(np.int32))
    other = (-np.sort(-other[0], 1), other[1])
    merged = ivf_scan.merge_topk(torch.from_numpy(other[0]),
                                 torch.from_numpy(other[1]), *got, k)
    jm = jax_scan.merge_topk(jnp.asarray(other[0]), jnp.asarray(other[1]),
                             *(jnp.asarray(np.asarray(a)) for a in got), k)
    _assert_topk_agree(merged, jm)


@pytest.mark.parametrize("counts_max", [0, 1, 128, 129, 512, 513, 1500])
def test_choose_lmax_equals_jax(counts_max):
    assert choose_lmax(counts_max) == jax_lmax(counts_max)


@pytest.mark.parametrize("work,nq", [(1 << 19, 256), (1 << 19, 255),
                                     (1 << 18, 1024), (1 << 22, 64)])
def test_pairs_gate_static_rule(monkeypatch, work, nq):
    """With no measured rows on this card, the port's gate is the static
    rule, as the JAX gate is when given an empty table."""
    static = work >= (1 << 19) and nq >= 256
    monkeypatch.setattr(config, "device", "cpu")
    index = build_index(128, "IVF4,Flat", resolve_metric("L2"))
    assert index.pairs_wanted(nq, work // 128) \
        == jax_gate.pairs_preferred(work, nq, 128, table=[],
                                    static_ok=static) == static


# --- wrappers: CPU tensors take the plain version, nothing else falls back ----

def test_wrappers_route_cpu_tensors_to_plain_versions():
    lists, counts, row_pos, probe, xq, mask = _layout(1, 4, 2)
    before = (k6.LAUNCHES, k7.LAUNCHES)
    k6.ivf_list_search(*_t(lists, counts, row_pos, probe, xq, mask), k=5,
                       metric="L2")
    k7.ivf_pairs_search(*_t(lists, counts, row_pos, probe, xq, None), k=5,
                        k_scan=20, metric="L2")
    assert (k6.LAUNCHES, k7.LAUNCHES) == before


@pytest.mark.parametrize("which", ["lists", "xq", "probe_ids"])
def test_list_scan_never_falls_back_off_the_cpu(which):
    """A tensor on a device the kernel cannot launch on raises before any
    score is computed."""
    lists, counts, _, probe, xq, _ = _layout(1, 4, 2)
    args = dict(zip(("lists", "counts", "probe_ids", "xq"),
                    _t(lists, counts, probe, xq)))
    args[which] = args[which].to("meta")
    with pytest.raises(ValueError, match="same CUDA device"):
        k6.ivf_list_scan(**args, mask=None, metric="L2")


@pytest.mark.parametrize("which", ["lists", "xq_t"])
def test_pairs_scan_never_falls_back_off_the_cpu(which):
    lists, counts, _, _, _, _ = _layout(1, 4, 2)
    args = dict(lists=torch.from_numpy(lists), counts=torch.from_numpy(counts),
                xq_t=torch.zeros((4, k7.QG, D)),
                qs_t=torch.zeros((4, k7.QG, 4)),
                meta=torch.zeros(5, dtype=torch.int32))
    args[which] = args[which].to("meta")
    with pytest.raises(ValueError, match="same CUDA device"):
        k7.ivf_pairs_scan(**args, mask=None, metric="L2")
