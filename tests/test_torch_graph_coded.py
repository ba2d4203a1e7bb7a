"""The port's SQ-coded graph build and walk (ops/graph.py, ``codec=``)
against the JAX package's coded functions (cf. tests/test_graph.py's
``test_coded_graph_build_and_walk`` and ``test_sq6_coded_walk``), on the
same packed codes, membership tables and graphs, and against the port's
own fp32 paths over the decoded rows.

* Clustered scan (``_clustered_knn_scan(codec=)``) and one NN-descent
  round (``_nn_descent_round(codec=)``), both at HIGHEST: each row's
  neighbour scores, recomputed in fp64 from the decoded rows, within 1e-5
  of the row's scale (its largest |score| or |x|²), and the ids equal
  wherever the neighbouring fp64 scores are further apart than that.
* Walk (``graph_search(codec=)`` at HIGHEST): distances within 1e-5 of
  the batch's largest |distance| and |q|², labels equal wherever the
  neighbouring distances are further apart; every distance the fp64
  distance of its decoded row within the same tolerance.
* Coded against fp32 over the decoded rows: the clustered scan, the
  descent round and the walk give equal ids and labels, and equal scores
  (the same torch ops on the same fp32 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from duckdb_faiss_ext_tpu.ops import graph as jg
from duckdb_faiss_ext_tpu.ops import sq as jsq
from duckdb_faiss_ext_tpu.ops.flat_search import \
    finalize_scores as jax_finalize
from duckdb_faiss_ext_tpu.utils.config import next_capacity, pad_rows
from duckdb_faiss_ext_tpu_torch.ops import graph as tg
from duckdb_faiss_ext_tpu_torch.ops import sq as tsq
from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores

CODECS = ("sq8", "sq6", "sq4")
METRICS = ("L2", "INNER_PRODUCT")
N, D, NLIST, INTER, DEG = 3000, 24, 16, 16, 12
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small CPU ops: one torch thread, as tests/test_torch_graph.py."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clustered(n, d, seed, ncenters=32, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncenters, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, ncenters, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


def _coded(codec, metric, n=N, d=D, seed=21):
    """(rows, packed codes, vmin, scale, decoded fp32 rows, decoded fp64)
    with the JAX package's training, quantization and packing; the port's
    decode of the same codes."""
    xb = _clustered(n, d, seed)
    if metric == "INNER_PRODUCT":
        xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    vmin, scale = jsq.sq_train(jnp.asarray(xb), jsq.SQ_LEVELS[codec])
    q = np.array(jsq.sq_quantize(jnp.asarray(xb), vmin, scale,
                                 levels=jsq.SQ_LEVELS[codec]))
    codes = {"sq8": lambda c: c, "sq6": jsq.sq6_pack,
             "sq4": jsq.sq4_pack}[codec](q)
    assert np.array_equal(codes, tsq.sq_pack(q, codec))   # byte-equal
    vmin, scale = np.array(vmin), np.array(scale)
    dec = tsq.sq_decode(torch.from_numpy(codes), torch.from_numpy(vmin),
                        torch.from_numpy(scale), codec).numpy()
    dec64 = (tsq.sq_unpack_host(codes, d, codec).astype(np.float64)
             * scale.astype(np.float64) + vmin.astype(np.float64))
    return xb, codes, vmin, scale, dec, dec64


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _scores64(x, y, metric):
    if metric == "INNER_PRODUCT":
        return x @ y.T
    return -((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def _neighbour_scores(ids, dec64, metric):
    """fp64 scores of each row against its listed neighbours, -inf at -1."""
    s = _scores64(dec64, dec64, metric)
    out = np.take_along_axis(s, np.maximum(ids, 0), 1)
    return np.where(ids >= 0, out, -np.inf)


def _row_tol(scores, x):
    finite = np.where(np.isfinite(scores), np.abs(scores), 0)
    return TOL * np.maximum(finite.max(1), (x * x).sum(1))


def _assert_rows_agree(got, want, dec64, metric):
    """Per row: the neighbour scores (fp64) within the row's tolerance;
    ids equal wherever the neighbouring scores are apart.  The last kept
    entry is compared by score only: the first entry left out, which could
    tie it, is not known."""
    assert got.shape == want.shape and got.dtype == np.int32
    sg = _neighbour_scores(got, dec64, metric)
    sw = _neighbour_scores(want, dec64, metric)
    np.testing.assert_array_equal(np.isfinite(sg), np.isfinite(sw))
    tol = _row_tol(sw, dec64)
    live = np.isfinite(sw)
    assert (np.abs(np.where(live, sg - sw, 0)) <= tol[:, None]).all()
    key = np.where(live, sw, -1e30)
    gap = np.abs(np.diff(key, axis=1)) > tol[:, None]
    sep = np.zeros_like(live)
    sep[:, :-1] = gap
    sep[:, 1:-1] &= gap[:, :-1]
    np.testing.assert_array_equal(got[sep], want[sep])
    assert sep.mean() > 0.6


def _table(dec, metric):
    """One membership table for both packages (the JAX package's k-means
    and top-2 assignment over the decoded rows)."""
    from duckdb_faiss_ext_tpu.ops.kmeans import kmeans_fit

    cents, _ = kmeans_fit(dec[::3], NLIST, seed=0)
    a12 = jg._top2_assign(dec, np.asarray(cents), metric, 0.0,
                          lax.Precision.HIGHEST)
    return jg.membership_table(a12, NLIST, INTER)


def _jax_scan(codes, table, lmax, metric, codec, vmin, scale):
    cap = next_capacity(N)
    out = jg._clustered_knn_scan(
        jnp.asarray(pad_rows(codes, cap)), jnp.asarray(table),
        jnp.float32(0.0), degree=INTER, lmax=int(lmax), nlist=NLIST,
        metric=metric, precision=lax.Precision.HIGHEST, codec=codec,
        vmin=jnp.asarray(vmin), scale=jnp.asarray(scale))
    return np.asarray(out[:N])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_coded_clustered_scan_matches_jax(codec, metric):
    _, codes, vmin, scale, dec, dec64 = _coded(codec, metric)
    table, lmax = _table(dec, metric)
    want = _jax_scan(codes, table, lmax, metric, codec, vmin, scale)
    codes_t, vmin_t, scale_t = _t(codes, vmin, scale)
    got = tg.clustered_knn_scan(codes_t, table, INTER, metric, codec, vmin_t,
                                scale_t).numpy()
    assert not (got == np.arange(N)[:, None]).any()
    _assert_rows_agree(got, want, dec64, metric)
    # The fp32 scan over the decoded rows gives the same ids.
    plain = tg.clustered_knn_scan(torch.from_numpy(dec), table, INTER,
                                  metric).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_coded_descent_round_matches_jax(codec, metric):
    _, codes, vmin, scale, dec, dec64 = _coded(codec, metric)
    rng = np.random.default_rng(5)
    s = rng.standard_normal((N, N))
    np.fill_diagonal(s, np.inf)
    knn = np.argsort(s, axis=1)[:, :INTER].astype(np.int32)
    knn[::7, INTER // 2:] = -1                      # short rows too
    cap = next_capacity(N)
    g = np.full((cap, INTER), -1, np.int32)
    g[:N] = knn
    want = np.asarray(jg._nn_descent_round(
        jnp.asarray(pad_rows(codes, cap)), jnp.asarray(g), jnp.float32(0.0),
        sample=4, q_block=64, metric=metric,
        precision=lax.Precision.HIGHEST, codec=codec,
        vmin=jnp.asarray(vmin), scale=jnp.asarray(scale)))[:N]
    codes_t, vmin_t, scale_t = _t(codes, vmin, scale)
    got = tg.nn_descent_round(codes_t, torch.from_numpy(knn), metric, 4,
                              codec, vmin_t, scale_t).numpy()
    assert not (got == np.arange(N)[:, None]).any()
    _assert_rows_agree(got, want, dec64, metric)
    plain = tg.nn_descent_round(torch.from_numpy(dec), torch.from_numpy(knn),
                                metric, 4).numpy()
    np.testing.assert_array_equal(got, plain)
    # refine_knn_graph is the same round.
    again = tg.refine_knn_graph(codes_t, N, torch.from_numpy(knn), metric,
                                rounds=1, sample=4, codec=codec, vmin=vmin_t,
                                scale=scale_t).numpy()
    np.testing.assert_array_equal(again, got)


#: 10,000 rows (16,384 capacity): the walk's seeds are a strided sample
N_WALK = 10_000


@pytest.fixture(scope="module")
def walk_graphs():
    """One adjacency a (codec, metric): the port's exact build over the
    decoded rows, augmented; both packages walk it."""
    out = {}

    def graph(codec, metric):
        if (codec, metric) not in out:
            _, _, _, _, dec, _ = _coded(codec, metric, n=N_WALK, seed=31)
            knn = tg.build_knn_graph(torch.from_numpy(dec), N_WALK, 2 * DEG,
                                     metric)
            g = tg.augment_graph(knn, DEG).numpy()
            out[codec, metric] = np.concatenate(
                [g, np.full((next_capacity(N_WALK) - N_WALK, DEG), -1,
                            np.int32)])
        return out[codec, metric]

    return graph


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_coded_walk_matches_jax(walk_graphs, codec, metric):
    k, pool, width = 10, 64, 8
    xb, codes, vmin, scale, dec, dec64 = _coded(codec, metric, n=N_WALK,
                                                seed=31)
    xq = _clustered(32, D, seed=32)
    if metric == "INNER_PRODUCT":
        xq /= np.linalg.norm(xq, axis=1, keepdims=True)
    g_pad = walk_graphs(codec, metric)
    cap = g_pad.shape[0]
    codes_pad = pad_rows(codes, cap)
    s, p = jg.graph_search(
        jnp.asarray(codes_pad), jnp.asarray(g_pad), jnp.asarray(xq), N_WALK,
        k + 1, metric, pool=pool, width=width,
        precision=lax.Precision.HIGHEST, codec=codec, vmin=jnp.asarray(vmin),
        scale=jnp.asarray(scale))
    wd, wl = (np.asarray(t) for t in jax_finalize(s, p, metric))
    codes_t, vmin_t, scale_t = _t(codes_pad, vmin, scale)
    s, p = tg.graph_search(codes_t, torch.from_numpy(g_pad),
                           torch.from_numpy(xq), N_WALK, k, metric,
                           pool=pool, width=width, codec=codec, vmin=vmin_t,
                           scale=scale_t)
    gd, gl = (t.numpy() for t in finalize_scores(s, p, metric))
    assert gl.shape == (32, k) and gl.dtype == np.int32
    assert (gl >= 0).all() and gl.max() < N_WALK
    sim = metric == "INNER_PRODUCT"
    live = np.isfinite(wd)
    scale_b = max(float(np.abs(wd[live]).max()),
                  float((xq.astype(np.float64) ** 2).sum(1).max()))
    tol = TOL * scale_b
    np.testing.assert_allclose(gd, wd[:, :k], rtol=0, atol=tol)
    key = -wd if sim else wd
    gap = np.abs(np.diff(key, axis=1)) > 2 * tol
    sep = gap.copy()
    sep[:, 1:] &= gap[:, :-1]
    np.testing.assert_array_equal(gl[sep[:, :k]], wl[:, :k][sep[:, :k]])
    # Every distance is the fp64 distance of its decoded row.
    full = _scores64(xq.astype(np.float64), dec64, metric)
    ref = np.take_along_axis(full if sim else -full, gl, 1)
    np.testing.assert_allclose(gd, ref, rtol=0, atol=tol)
    # The same walk over the decoded fp32 rows (its pool rescored in fp32,
    # as the coded walk's always is) gives the same result.
    s, p = tg.graph_search(torch.from_numpy(pad_rows(dec, cap)),
                           torch.from_numpy(g_pad), torch.from_numpy(xq),
                           N_WALK, k, metric, pool=pool, width=width,
                           rerank=True)
    pd, pl = (t.numpy() for t in finalize_scores(s, p, metric))
    np.testing.assert_array_equal(gl, pl)
    np.testing.assert_array_equal(gd, pd)
    # L2 recall against the decoded corpus: tests/test_graph.py's floor
    # for its sq6 walk.
    if not sim:
        oracle = np.argsort(-full, axis=1)[:, :k]
        recall = np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(gl, oracle)])
        assert recall > 0.85


def test_fetch_rows_decodes_in_place():
    """fetch_rows gathers and decodes any id shape, and gathers fp32 rows
    as they are."""
    _, codes, vmin, scale, dec, _ = _coded("sq6", "L2", n=64)
    codes_t, vmin_t, scale_t = _t(codes, vmin, scale)
    ids = torch.tensor([[3, 0, 63], [5, 5, 1]])
    rows = tg.fetch_rows(codes_t, ids, "sq6", vmin_t, scale_t)
    assert rows.shape == (2, 3, D) and rows.dtype == torch.float32
    np.testing.assert_array_equal(rows.numpy(), dec[ids.numpy()])
    plain = tg.fetch_rows(torch.from_numpy(dec), ids)
    np.testing.assert_array_equal(plain.numpy(), rows.numpy())
