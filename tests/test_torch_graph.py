"""The port's graph build and walk (ops/graph.py) against the JAX
package's (the ops-level cases of tests/test_graph.py).

* ``build_knn_graph``: equal adjacency wherever the neighbouring fp64
  distances of a row are further apart than 1e-5 of the row's scale (the
  larger of its largest |distance| and |x|², the terms an L2 distance
  cancels).
* ``augment_graph``: byte-equal to the JAX package's numpy function on the
  same k-NN input.
* The clustered build with NN-descent: the port's k-means is its own, so
  its lists differ; the edge recall of its k-NN graph against the exact
  one stays within 0.02 of the JAX package's.
* ``graph_search`` over the same adjacency (the JAX side at HIGHEST, no
  pack): distances within 1e-5 of the batch's largest |distance| and |q|²,
  labels equal wherever the neighbouring distances are further apart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from duckdb_faiss_ext_tpu.ops import graph as jg
from duckdb_faiss_ext_tpu.ops.flat_search import \
    finalize_scores as jax_finalize
from duckdb_faiss_ext_tpu.utils.config import next_pow2, pad_rows
from duckdb_faiss_ext_tpu_torch.ops import graph as tg
from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: these tests issue many small ops,
    which torch's thread pool slows tenfold when test workers share the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clustered(n, d, seed=0, ncenters=32, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncenters, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, ncenters, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


def _scores64(x, y, metric):
    """fp64 max-oriented scores of rows x against rows y."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    if metric == "INNER_PRODUCT":
        return x @ y.T
    return -((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def _knn_oracle(xb, degree, metric):
    """Each row's best degree + 1 fp64 scores over the other rows."""
    s = _scores64(xb, xb, metric)
    np.fill_diagonal(s, -np.inf)
    return -np.sort(-s, axis=1)[:, :degree + 1], s


def _row_tol(scores, xb):
    """1e-5 of each row's scale: its largest finite |score| or |x|²."""
    finite = np.where(np.isfinite(scores), np.abs(scores), 0)
    return 1e-5 * np.maximum(finite.max(1), (xb.astype(np.float64) ** 2)
                             .sum(1))


def _apart(scores, tol):
    """(R, W) bool: entries whose score is further than tol from both
    neighbours in its row (scores has one column beyond W)."""
    gap = np.abs(np.diff(scores, axis=1)) > tol[:, None]
    sep = gap.copy()
    sep[:, 1:] &= gap[:, :-1]
    return sep


@pytest.mark.parametrize("metric,n,d,degree", [
    ("L2", 2000, 16, 8), ("L2", 3000, 8, 33), ("INNER_PRODUCT", 2000, 16, 8),
    ("INNER_PRODUCT", 2500, 12, 24)])
def test_build_knn_graph_matches_jax(metric, n, d, degree):
    xb = _clustered(n, d, seed=degree)
    want = jg.build_knn_graph(xb, degree, metric,
                              precision=lax.Precision.HIGHEST)
    got = tg.build_knn_graph(torch.from_numpy(xb), n, degree,
                             metric).numpy()
    assert got.dtype == np.int32 and got.shape == (n, degree)
    assert not (got == np.arange(n)[:, None]).any()
    oracle, _ = _knn_oracle(xb, degree, metric)
    tol = _row_tol(oracle, xb)
    sep = _apart(oracle, tol)
    np.testing.assert_array_equal(got[sep], want[sep])
    assert sep.mean() > 0.8


def test_build_knn_graph_duplicates_rank_by_position():
    """Rows with exact duplicates: each row's own position is dropped and
    the rest rank by ascending position, as the JAX package's masked scan
    ranks them."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((40, 8)).astype(np.float32)
    xb = np.concatenate([base] * 6)            # every row six times
    got = tg.build_knn_graph(torch.from_numpy(xb), 240, 7, "L2").numpy()
    want = jg.build_knn_graph(xb, 7, "L2", precision=lax.Precision.HIGHEST)
    np.testing.assert_array_equal(got[:, :5], want[:, :5])
    twins = (np.arange(240)[:, None] % 40 + 40 * np.arange(6)[None, :])
    for r in range(240):
        np.testing.assert_array_equal(got[r, :5], twins[r][twins[r] != r])


def test_build_knn_graph_tiny_corpus():
    xb = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    got = tg.build_knn_graph(torch.from_numpy(xb), 5, 8, "L2").numpy()
    want = jg.build_knn_graph(xb, 8, "L2", precision=lax.Precision.HIGHEST)
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0).sum(1) == 4).all()


def _random_knn(n, kd, seed, holes=0.0):
    """Rows of distinct non-self ids, some slots -1 (padding at the end)."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, n))
    np.fill_diagonal(s, np.inf)
    knn = np.argsort(s, axis=1)[:, :kd].astype(np.int32)
    cut = rng.integers(1, kd + 1, n)
    keep = rng.random(n) >= holes
    cut = np.where(keep, kd, cut)
    return np.where(np.arange(kd)[None, :] < cut[:, None], knn, -1)


@pytest.mark.parametrize("n,kd,deg,fkeep,holes", [
    (64, 16, 8, None, 0.0), (64, 16, 8, 4, 0.0), (300, 24, 16, None, 0.3),
    (300, 24, 16, 5, 0.3), (200, 12, 16, None, 0.5), (500, 32, 32, 1, 0.1)])
def test_augment_graph_byte_equal(n, kd, deg, fkeep, holes):
    knn = _random_knn(n, kd, seed=n + kd, holes=holes)
    want = jg.augment_graph(knn, deg, fkeep)
    got = tg.augment_graph(torch.from_numpy(knn), deg, fkeep).numpy()
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_augment_graph_byte_equal_on_built_knn():
    """The JAX package's own exact k-NN graph as input."""
    xb = _clustered(3000, 16, seed=9)
    knn = jg.build_knn_graph(xb, 32, "L2")
    for fkeep in (None, 8):
        want = jg.augment_graph(knn, 16, fkeep)
        got = tg.augment_graph(torch.from_numpy(knn.copy()), 16,
                               fkeep).numpy()
        assert got.tobytes() == want.tobytes()


def test_augment_graph_forward_first_default():
    """The default keeps every forward edge (reverse edges only backfill
    missing slots); the half/half split stays available via fkeep."""
    rng = np.random.default_rng(0)
    n, inter, deg = 64, 16, 8
    scores = rng.standard_normal((n, n))
    np.fill_diagonal(scores, np.inf)
    knn = torch.from_numpy(np.argsort(scores, axis=1)[:, :inter]
                           .astype(np.int32))
    g = tg.augment_graph(knn, deg)
    torch.testing.assert_close(g, knn[:, :deg], rtol=0, atol=0)
    half = tg.augment_graph(knn, deg, fkeep=deg // 2)
    torch.testing.assert_close(half[:, :deg // 2], knn[:, :deg // 2],
                               rtol=0, atol=0)
    assert not torch.equal(half, knn[:, :deg])
    knn2 = knn.clone()
    knn2[0, 2:] = -1
    assert (tg.augment_graph(knn2, deg)[0] >= 0).sum() > 2


def test_build_graph_properties():
    xb = _clustered(2000, 16, seed=1)
    g = tg.build_graph(torch.from_numpy(xb), 2000, 8, "L2").numpy()
    assert g.shape == (2000, 8) and g.dtype == np.int32
    assert not (g == np.arange(2000)[:, None]).any()
    for row in g:
        ids = row[row >= 0]
        assert len(set(ids.tolist())) == len(ids)
    want = jg.build_graph(xb, 8, "L2", precision=lax.Precision.HIGHEST)
    assert (g == want).mean() > 0.99


def _edge_recall(knn, exact):
    return np.mean([len(set(a[a >= 0]) & set(b)) / len(b)
                    for a, b in zip(knn, exact)])


@pytest.mark.parametrize("metric,rounds", [("L2", 1), ("L2", 2),
                                           ("INNER_PRODUCT", 1)])
def test_clustered_build_edge_recall_within_jax(metric, rounds):
    """k-means differs between the packages (a named deviation), so the
    clustered graphs differ; their edge recall against the exact k-NN
    graph agrees within 0.02, before and after NN-descent."""
    n, d, deg = 6000, 16, 16
    xb = _clustered(n, d, seed=80, ncenters=128)
    if metric == "INNER_PRODUCT":
        xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    exact = jg.build_knn_graph(xb, deg, metric,
                               precision=lax.Precision.HIGHEST)
    xt = torch.from_numpy(xb)
    got = tg.build_knn_graph_clustered(xt, n, deg, metric)
    want = jg.build_knn_graph_clustered(xb, deg, metric,
                                        precision=lax.Precision.HIGHEST)
    assert not (got.numpy() == np.arange(n)[:, None]).any()
    r_got, r_want = _edge_recall(got.numpy(), exact), _edge_recall(want,
                                                                   exact)
    assert abs(r_got - r_want) <= 0.02, (r_got, r_want)
    got = tg.refine_knn_graph(xt, n, got, metric, rounds=rounds)
    want = jg.refine_knn_graph(xb, want, metric, rounds=rounds,
                               precision=lax.Precision.HIGHEST)
    assert not (got.numpy() == np.arange(n)[:, None]).any()
    r_got, r_want = _edge_recall(got.numpy(), exact), _edge_recall(want,
                                                                   exact)
    assert abs(r_got - r_want) <= 0.02, (r_got, r_want)
    assert r_got > 0.9


def test_nn_descent_round_matches_jax_on_same_input():
    """One round over the same input graph: equal rows wherever the fp64
    scores are apart."""
    n, d, deg = 3000, 12, 12
    xb = _clustered(n, d, seed=31)
    knn = _random_knn(n, deg, seed=31)
    want = jg.refine_knn_graph(xb, knn, "L2", rounds=1,
                               precision=lax.Precision.HIGHEST)
    got = tg.refine_knn_graph(torch.from_numpy(xb), n,
                              torch.from_numpy(knn), "L2", rounds=1).numpy()
    s = np.take_along_axis(_scores64(xb, xb, "L2"), np.maximum(want, 0), 1)
    s = np.concatenate([s, np.full((n, 1), -np.inf)], 1)
    sep = _apart(np.where(np.isinf(s), -1e30, s), _row_tol(s, xb))
    np.testing.assert_array_equal(got[sep], want[sep])
    assert sep.mean() > 0.9


def test_build_graph_refine_rounds_knob():
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(rng.standard_normal((600, 16)).astype(np.float32))
    g1 = tg.build_graph(xb, 600, 8, "L2", exact_max=100, refine_rounds=1)
    g3 = tg.build_graph(xb, 600, 8, "L2", exact_max=100, refine_rounds=3)
    assert g1.shape == g3.shape == (600, 8)
    exact = tg.build_graph(xb, 600, 8, "L2")

    def overlap(a, b):
        return np.mean([len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
                        / 8 for x, y in zip(a.numpy(), b.numpy())])

    assert overlap(g3, exact) >= overlap(g1, exact) - 0.02


@pytest.mark.parametrize("pool,width,deg", [(16, 8, 32), (64, 8, 16),
                                            (256, 4, 128), (10, 3, 7)])
def test_default_iters_matches_jax(pool, width, deg):
    assert tg.default_iters(pool, width, deg) == jg.default_iters(pool, width,
                                                                  deg)


# --- the walk over a shared adjacency ----------------------------------------

#: 20,000 rows (a 32,768-row capacity): past 8,192 graph rows the walk's
#: seeds are a strided sample (stride 4), not an exact scan of every row
N_WALK, D_WALK, DEG_WALK = 20_000, 16, 16


@pytest.fixture(scope="module")
def walk_setup():
    """One corpus and one graph (the JAX package's build) for both walks;
    the corpus padded to a power-of-two capacity as the indexes pad it."""
    xb = _clustered(N_WALK, D_WALK, seed=3)
    g = jg.build_graph(xb, DEG_WALK, "L2", precision=lax.Precision.HIGHEST)
    cap = next_pow2(N_WALK)
    xb_pad = pad_rows(xb, cap)
    g_pad = np.concatenate([g, np.full((cap - N_WALK, DEG_WALK), -1,
                                       np.int32)])
    xq = _clustered(64, D_WALK, seed=4)
    return xb_pad, g_pad, xq


def assert_agree(dist, labels, want_d, want_l, xq, sim):
    """Distances within 1e-5 of the batch's scale, labels equal where the
    neighbouring distances are further apart than that.  ``want`` is one
    wider than the result (the same walk: its pool does not depend on k),
    so the last label is checked only where the next distance is apart."""
    k = labels.shape[1]
    finite = np.isfinite(want_d[:, :k])
    np.testing.assert_array_equal(np.isfinite(dist), finite)
    np.testing.assert_array_equal(labels[~finite], want_l[:, :k][~finite])
    live = np.isfinite(want_d)
    scale = max(float(np.abs(want_d[live]).max()) if live.any() else 1.0,
                float((xq * xq).sum(1).max()))
    tol = 1e-5 * scale
    np.testing.assert_allclose(dist[finite], want_d[:, :k][finite], rtol=0,
                               atol=tol)
    key = np.where(live, -want_d if sim else want_d, 1e30)
    gap = np.abs(np.diff(key, axis=1)) > 2 * tol
    sep = finite & gap
    sep[:, 1:] &= gap[:, :-1]
    np.testing.assert_array_equal(labels[sep], want_l[:, :k][sep])


def _walks(xb_pad, g_pad, xq, nvalid, k, metric, pool, width, mask,
           fast=False):
    """The port's walk at k and the JAX package's at k + 1."""
    prec = lax.Precision.DEFAULT if fast else lax.Precision.HIGHEST
    s, p = jg.graph_search(
        jnp.asarray(xb_pad), jnp.asarray(g_pad), jnp.asarray(xq), nvalid,
        k + 1, metric, pool=pool, width=width,
        mask=None if mask is None else jnp.asarray(mask), precision=prec)
    wd, wl = (np.asarray(t) for t in jax_finalize(s, p, metric))
    s, p = tg.graph_search(
        torch.from_numpy(xb_pad), torch.from_numpy(g_pad),
        torch.from_numpy(xq), nvalid, k, metric, pool=pool, width=width,
        mask=None if mask is None else torch.from_numpy(mask), rerank=fast)
    gd, gl = (t.numpy() for t in finalize_scores(s, p, metric))
    return gd, gl, wd, wl


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,pool", [(1, 16), (10, 64), (10, 256)])
def test_graph_search_matches_jax(walk_setup, metric, masked, k, pool):
    xb_pad, g_pad, xq = walk_setup
    mask = (np.arange(xb_pad.shape[0]) % 3 == 0) if masked else None
    gd, gl, wd, wl = _walks(xb_pad, g_pad, xq, N_WALK, k, metric, pool, 8,
                            mask)
    assert gl.shape == (64, k) and gl.dtype == np.int32
    assert_agree(gd, gl, wd, wl, xq, metric == "INNER_PRODUCT")
    if masked:
        assert (gl[gl >= 0] % 3 == 0).all()


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_graph_search_nvalid_below_capacity(walk_setup, metric):
    """Only the first 12,000 nodes are graph rows (the rest -1, as after a
    build over a prefix); no seed or result past them."""
    xb_pad, g_pad, xq = walk_setup
    g = jg.build_graph(xb_pad[:12_000], DEG_WALK, metric,
                       precision=lax.Precision.HIGHEST)
    g_pad = np.concatenate([g, np.full((xb_pad.shape[0] - 12_000, DEG_WALK),
                                       -1, np.int32)])
    gd, gl, wd, wl = _walks(xb_pad, g_pad, xq, 12_000, 10, metric, 64, 4,
                            None)
    assert_agree(gd, gl, wd, wl, xq, metric == "INNER_PRODUCT")
    assert gl.max() < 12_000


def test_graph_search_fast_mode_reranks(walk_setup):
    """Fast mode: the pool is rescored in full fp32 before extraction (the
    JAX package reranks below HIGHEST)."""
    xb_pad, g_pad, xq = walk_setup
    gd, gl, wd, wl = _walks(xb_pad, g_pad, xq, N_WALK, 10, "L2", 64, 8,
                            None, fast=True)
    assert_agree(gd, gl, wd, wl, xq, False)


def test_graph_walk_recall_and_determinism():
    """tests/test_graph.py's walk case on the port: 8,000 rows, degree 16,
    pool 64."""
    n = 8000
    xb_pad = pad_rows(_clustered(n, 16, seed=3), next_pow2(n))
    xq = _clustered(64, 16, seed=4)
    xt = torch.from_numpy(xb_pad)
    g = tg.build_graph(xt, n, 16, "L2")
    g_pad = torch.cat([g, torch.full((xb_pad.shape[0] - n, 16), -1,
                                     dtype=torch.int32)])
    out = [finalize_scores(*tg.graph_search(xt, g_pad, torch.from_numpy(xq),
                                            n, 10, "L2", pool=64, width=8),
                           "L2")
           for _ in range(2)]
    dist, pos = (t.numpy() for t in out[0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=0, atol=0)
    d2 = -_scores64(xq, xb_pad[:n], "L2")
    oracle = np.argsort(d2, axis=1)[:, :10]
    recall = np.mean([len(set(pos[i]) & set(oracle[i])) / 10
                      for i in range(len(xq))])
    assert recall > 0.95
    dd = np.take_along_axis(d2, np.maximum(pos, 0), axis=1)
    np.testing.assert_allclose(dist, dd, rtol=1e-4, atol=1e-4)
    assert (np.diff(dist, axis=1) >= -1e-6).all()
