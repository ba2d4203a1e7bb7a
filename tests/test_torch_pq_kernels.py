"""The port's IVF-PQ / IVF-RQ list scan (K8) and the PQ / RQ codecs against
the JAX package's.

On CPU tensors the port's K8 wrapper runs its plain torch version; the JAX
side runs ``pallas_gather_lists`` / ``pallas_ivf_pq_search`` with the
Pallas gather kernel in interpret mode, on the same padded code layout,
codebooks, centroids, probe table and queries, made from numpy with a
seed.  The codecs (ops/pq.py, ops/rq.py) run on the same codes, codebooks
and rows in both packages.

Tolerances:

* gathered code blocks, decoded rows: exact equality (a gather, and for RQ
  the stage codewords summed in the same order);
* searches: scores within 1e-5 of each query's scale (the larger of its
  largest |score| and |q|²: the packages sum the decoded rows' terms in
  another order), positions equal wherever the neighbouring scores are
  further apart than that;
* codes: equal wherever the best and the second-best cost are further
  apart than fp32 rounding; where codes differ, their costs must be that
  close (the two packages' matmuls round differently at near-ties);
* one anisotropic Lloyd step: 1e-5 relative (a batched linear solve).

Training differs by design (the port's generator is not JAX's), so it is
tested for determinism under the seed and for its shapes.  The CUDA kernel
itself is held against its plain version on the card (chip_smoke.py, and
the ``gpu``-marked cases of tests/test_torch_package.py, which the card's
machine runs without JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from duckdb_faiss_ext_tpu.ops import pq as jpq
from duckdb_faiss_ext_tpu.ops import rq as jrq
from duckdb_faiss_ext_tpu.ops.pallas_ivf import (pallas_gather_lists,
                                                 pallas_ivf_pq_search)
from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8
from duckdb_faiss_ext_tpu_torch.ops import pq as ppq
from duckdb_faiss_ext_tpu_torch.ops import rq as prq

NLIST, LMAX = 8, 128
REL_TOL = 1e-5


def _codebooks(rng, codec, m, nbits, d):
    dim = d // m if codec == "pq" else d
    return rng.standard_normal((m, 1 << nbits, dim)).astype(np.float32)


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
    probe[0, 0] = 2                                 # the empty list
    probe[1, -1] = 1                                # the full list
    return dict(lists=lists, counts=counts, row_pos=row_pos,
                cb=_codebooks(rng, codec, m, nbits, d),
                cents=rng.standard_normal((NLIST, d)).astype(np.float32),
                probe=probe,
                xq=rng.standard_normal((nq, d)).astype(np.float32),
                mask=(rng.random((NLIST, LMAX)) < 0.6).astype(np.int8))


def _assert_search_agrees(got, want, xq):
    gs, gp = (t.numpy() for t in got)
    ws, wp = (np.asarray(t) for t in want)
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


# --- K8 and its plain counterparts ------------------------------------------

@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_gather_lists_bit_equal(nprobe):
    """The port's gather equals the TPU kernel's own function, interpreted."""
    L = _layout(1, "pq", 4, 8, 16, 6, nprobe)
    got = k8.gather_lists(torch.from_numpy(L["lists"]),
                          torch.from_numpy(L["probe"]))
    want = pallas_gather_lists(jnp.asarray(L["lists"]),
                               jnp.asarray(L["probe"]), nprobe=nprobe,
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,m,nbits", [("pq", 4, 8), ("pq", 8, 4),
                                           ("rq", 2, 4), ("rq", 4, 8)])
def test_list_search_matches_jax(codec, m, nbits, metric, masked):
    """``ivf_pq_list_search`` against ``pallas_ivf_pq_search`` (interpreted
    gather kernel) on the same layout: counts 0 and lmax, exact ties."""
    d, nq, nprobe, k = 16, 16, 4, 20
    L = _layout(2, codec, m, nbits, d, nq, nprobe)
    mask = L["mask"] if masked else None
    t = {n: torch.from_numpy(L[n]) for n in ("lists", "counts", "row_pos",
                                             "cb", "cents", "probe", "xq")}
    got = k8.ivf_pq_list_search(
        t["lists"], t["counts"], t["row_pos"], t["cb"], t["cents"],
        t["probe"], t["xq"], None if mask is None else torch.from_numpy(mask),
        k=k, metric=metric, codec=codec)
    want = pallas_ivf_pq_search(
        *(jnp.asarray(L[n]) for n in ("lists", "counts", "row_pos", "cb",
                                      "cents", "probe", "xq")),
        None if mask is None else jnp.asarray(mask), k=k, nprobe=nprobe,
        metric=metric, q_chunk=8, precision=lax.Precision.HIGHEST,
        interpret=True, codec=codec)
    _assert_search_agrees(got, want, L["xq"])
    # Tied rows (slots 4 and 5 of a list) resolve to the lower storage row.
    s, p = (x.numpy() for x in got)
    tied = (s[:, 1:] == s[:, :-1]) & np.isfinite(s[:, 1:])
    assert (p[:, 1:][tied] > p[:, :-1][tied]).all()


@pytest.mark.parametrize("codec", ["pq", "rq"])
def test_raw_scores_mask_counts_and_residual(codec):
    """The plain raw scores of K8's probed slots (its plain building block
    and oracle) take every slot as dec(code) + centroid against the query:
    -inf past the count and where the mask is 0, the difference-form L2
    otherwise; nothing launches a kernel."""
    d, nq, nprobe, m = 16, 4, 3, 4
    L = _layout(3, codec, m, 8, d, nq, nprobe)
    t = {n: torch.from_numpy(L[n]) for n in L}
    before = k8.LAUNCHES
    raw = k8.ivf_pq_scan_reference(t["lists"], t["counts"], t["probe"],
                                   t["xq"], t["cents"], t["cb"], t["mask"],
                                   "L2", codec)
    assert k8.LAUNCHES == before and raw.shape == (nq, nprobe, LMAX)
    for q in range(nq):
        for j in range(nprobe):
            li = L["probe"][q, j]
            codes = torch.from_numpy(L["lists"][li])
            x = ppq.codec_decode(codes, t["cb"], codec).numpy() + L["cents"][li]
            want = -((x - L["xq"][q]) ** 2).sum(1)
            live = (np.arange(LMAX) < L["counts"][li]) & (L["mask"][li] != 0)
            got = raw[q, j].numpy()
            assert np.isneginf(got[~live]).all()
            np.testing.assert_allclose(got[live], want[live], rtol=1e-6,
                                       atol=1e-5)


# --- the codecs --------------------------------------------------------------

def _rows(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("m,nbits", [(4, 8), (8, 4), (16, 2)])
def test_pq_decode_bit_equal(m, nbits):
    rng = np.random.default_rng(5)
    cb = _codebooks(rng, "pq", m, nbits, 32)
    codes = rng.integers(0, 1 << nbits, (300, m)).astype(np.uint8)
    got = ppq.pq_decode(torch.from_numpy(codes), torch.from_numpy(cb))
    want = jpq.pq_decode(jnp.asarray(codes), jnp.asarray(cb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,nbits", [(2, 4), (4, 8), (8, 8)])
def test_rq_decode_bit_equal(m, nbits):
    rng = np.random.default_rng(6)
    cb = _codebooks(rng, "rq", m, nbits, 24)
    codes = rng.integers(0, 1 << nbits, (300, m)).astype(np.uint8)
    got = prq.rq_decode(torch.from_numpy(codes), torch.from_numpy(cb))
    want = jrq.rq_decode(jnp.asarray(codes), jnp.asarray(cb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pq_costs(x, cb):
    """(n, m, ksub) float64 squared distances of each subvector."""
    m, ksub, dsub = cb.shape
    xs = x.astype(np.float64).reshape(x.shape[0], m, dsub)
    return ((xs[:, :, None, :] - cb.astype(np.float64)[None]) ** 2).sum(-1)


def _assert_codes_agree(got, want, costs, scale):
    """Codes equal, except where the two picks' costs are within rounding."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(
        np.int64)
    differ = got != want
    assert differ.mean() < 0.01
    pick = np.take_along_axis
    cg = pick(costs, got[..., None], -1)[..., 0]
    cw = pick(costs, want[..., None], -1)[..., 0]
    assert (np.abs(cg - cw)[differ] <= 1e-5 * scale).all()


@pytest.mark.parametrize("m,nbits", [(4, 8), (8, 4)])
def test_pq_encode_matches_jax(m, nbits):
    rng = np.random.default_rng(7)
    cb = _codebooks(rng, "pq", m, nbits, 32)
    x = _rows(8, 2000, 32)
    got = ppq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb))
    want = jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb))
    assert got.dtype == torch.uint8 and got.shape == (2000, m)
    _assert_codes_agree(got.numpy(), want, _pq_costs(x, cb),
                        float((x * x).sum(1).max()))


def _aniso_costs(x, dirs, cb, eta):
    """(n, m, ksub) float64 score-aware costs."""
    m, ksub, dsub = cb.shape
    n = x.shape[0]
    xs = x.astype(np.float64).reshape(n, m, dsub)
    ds = dirs.astype(np.float64).reshape(n, m, dsub)
    xhat = ds / np.maximum(np.linalg.norm(ds, axis=-1, keepdims=True), 1e-10)
    r = xs[:, :, None, :] - cb.astype(np.float64)[None]
    par = (r * xhat[:, :, None, :]).sum(-1)
    return (r * r).sum(-1) + (np.float32(eta) - 1.0) * par * par


@pytest.mark.parametrize("with_dirs", [False, True])
def test_pq_encode_anisotropic_matches_jax(with_dirs):
    rng = np.random.default_rng(9)
    cb = _codebooks(rng, "pq", 4, 6, 16)
    x = _rows(10, 1500, 16)
    dirs = _rows(11, 1500, 16) if with_dirs else x
    eta = 3.5
    got = ppq.pq_encode_anisotropic(
        torch.from_numpy(x), torch.from_numpy(cb), eta,
        dirs=torch.from_numpy(dirs) if with_dirs else None)
    want = jpq.pq_encode_anisotropic(
        jnp.asarray(x), jnp.asarray(cb), eta,
        dirs=jnp.asarray(dirs) if with_dirs else None)
    _assert_codes_agree(got.numpy(), want, _aniso_costs(x, dirs, cb, eta),
                        float(eta * (x * x).sum(1).max()))


def test_aniso_step_matches_jax():
    """One anisotropic Lloyd step from the same initial centroids, one of
    them far away (an empty cluster keeps its centroid)."""
    x = _rows(12, 800, 4)
    xhat = x / np.linalg.norm(x, axis=1, keepdims=True)
    cents = x[:16].copy()
    cents[15] = 100.0
    got = ppq.aniso_step(torch.from_numpy(x), torch.from_numpy(xhat),
                         torch.from_numpy(cents), 2.5)
    want = jpq._aniso_step(jnp.asarray(x), jnp.asarray(xhat),
                           jnp.asarray(cents), jnp.float32(2.5),
                           lax.Precision.HIGHEST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[15], cents[15])


def _rq_error(x, cb, codes):
    rec = prq.rq_decode(torch.from_numpy(np.asarray(codes)),
                        torch.from_numpy(cb)).numpy().astype(np.float64)
    return ((x.astype(np.float64) - rec) ** 2).sum(1)


@pytest.mark.parametrize("beam", [1, 4])
def test_rq_encode_matches_jax(beam):
    """The beam search picks the JAX package's codes; where they differ the
    two final errors are equal within rounding (a near-tie in some stage)."""
    rng = np.random.default_rng(13)
    cb = _codebooks(rng, "rq", 4, 5, 16) * np.array(
        [1.0, 0.5, 0.25, 0.125], np.float32)[:, None, None]
    x = _rows(14, 1500, 16)
    got = prq.rq_encode(torch.from_numpy(x), torch.from_numpy(cb), beam=beam)
    want = np.asarray(jrq.rq_encode(jnp.asarray(x), jnp.asarray(cb),
                                    beam=beam))
    assert got.dtype == torch.uint8 and got.shape == (1500, 4)
    differ = (got.numpy() != want).any(1)
    assert differ.mean() < 0.01
    eg, ew = _rq_error(x, cb, got.numpy()), _rq_error(x, cb, want)
    scale = float((x * x).sum(1).max())
    assert (np.abs(eg - ew)[differ] <= 1e-5 * scale).all()
    if beam == 4:
        greedy = prq.rq_encode(torch.from_numpy(x), torch.from_numpy(cb),
                               beam=1).numpy()
        assert eg.mean() <= _rq_error(x, cb, greedy).mean()


def test_rq_beam_ties_resolve_to_the_lower_index():
    """Duplicated stage-0 codewords tie exactly: the beam keeps the lower
    flat index, as ``lax.top_k`` does."""
    rng = np.random.default_rng(15)
    cb = _codebooks(rng, "rq", 2, 3, 8)
    cb[0, 5] = cb[0, 2]
    x = cb[0, 2][None] + _rows(16, 50, 8) * 1e-3
    got = prq.rq_encode(torch.from_numpy(x), torch.from_numpy(cb), beam=1)
    want = np.asarray(jrq.rq_encode(jnp.asarray(x), jnp.asarray(cb), beam=1))
    np.testing.assert_array_equal(got.numpy()[:, 0], 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("codec", ["pq", "rq"])
def test_training_deterministic_under_seed(codec):
    x = torch.from_numpy(_rows(17, 600, 8))
    a = ppq.codec_train(x, 2, 16, codec, niter=5, seed=3)
    b = ppq.codec_train(x, 2, 16, codec, niter=5, seed=3)
    c = ppq.codec_train(x, 2, 16, codec, niter=5, seed=4)
    assert a.shape == ((2, 16, 4) if codec == "pq" else (2, 16, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_anisotropic_training_deterministic_and_eta_one_is_kmeans():
    x = torch.from_numpy(_rows(18, 600, 8))
    a = ppq.pq_train_anisotropic(x, 2, 16, 4.0, niter=4, seed=9)
    b = ppq.pq_train_anisotropic(x, 2, 16, 4.0, niter=4, seed=9)
    assert a.shape == (2, 16, 4) and torch.equal(a, b)
    # eta = 1 reduces the closed-form update to the cluster mean.
    xs, cents = x[:, :4].contiguous(), x[:16, :4].clone()
    step = ppq.aniso_step(xs, ppq._unit(xs), cents, 1.0)
    lab = ((xs[:, None] - cents[None]) ** 2).sum(-1).argmin(1)
    for j in range(16):
        if (lab == j).any():
            torch.testing.assert_close(step[j], xs[lab == j].mean(0),
                                       rtol=1e-5, atol=1e-5)
