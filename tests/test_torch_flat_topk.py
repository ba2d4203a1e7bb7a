"""The port's Flat kernel (K1) against the JAX package's.

``duckdb_faiss_ext_tpu_torch.ops.flat_topk.flat_topk`` on CPU tensors runs
its plain torch version; the JAX side runs the Pallas kernel
``_pallas_topk`` in interpret mode (as tests/test_pallas_topk.py does) and
the XLA scan ``flat_search``.  Inputs come from numpy with a fixed seed.

Tolerance: distances rtol=1e-5, atol=1e-5·max|score| (fp32 sums taken in
another order); positions exactly equal.  The kernel itself is checked
against this plain version on the card (tests/test_torch_package.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_faiss_ext_tpu.ops.flat_search import exact_topk as jax_exact_topk
from duckdb_faiss_ext_tpu.ops.flat_search import flat_search as jax_flat_search
from duckdb_faiss_ext_tpu.ops.pallas_topk import pallas_flat_search
from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk, topk_ordered

D = 32


def _inputs(seed, nq, cap, nvalid, masked):
    rng = np.random.default_rng(seed)
    xb = np.zeros((cap, D), np.float32)
    xb[:nvalid] = rng.standard_normal((nvalid, D)).astype(np.float32)
    xq = rng.standard_normal((nq, D)).astype(np.float32)
    mask = rng.random(cap) < 0.4 if masked else None
    return xb, xq, mask


def _port(xb, nvalid, xq, k, metric, mask):
    d, p = ft.kernel_flat_search(
        torch.from_numpy(xb), nvalid, torch.from_numpy(xq), k, metric,
        mask=None if mask is None else torch.from_numpy(mask))
    return d.numpy(), p.numpy()


def _assert_same(got, want):
    (gd, gp), (wd, wp) = got, want
    wd, wp = np.asarray(wd), np.asarray(wp)
    np.testing.assert_array_equal(gp, wp)
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    np.testing.assert_array_equal(gd[~finite], wd[~finite])
    scale = float(np.abs(wd[finite]).max()) if finite.any() else 1.0
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("nq,cap,nvalid", [(8, 256, 100), (16, 1024, 1000)])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_plain_matches_jax_kernel(metric, nq, cap, nvalid, k, masked):
    """Same (distance, position) lists as the interpreted Pallas kernel and
    the XLA scan; nvalid < cap, and with nvalid=100 and k=128 fewer valid
    rows than k (missing slots: sentinel distance, position -1)."""
    xb, xq, mask = _inputs(7, nq, cap, nvalid, masked)
    got = _port(xb, nvalid, xq, k, metric, mask)
    jmask = None if mask is None else jnp.asarray(mask)
    _assert_same(got, pallas_flat_search(
        jnp.asarray(xb), nvalid, jnp.asarray(xq), k, metric, mask=jmask,
        interpret=True))
    _assert_same(got, jax_flat_search(
        jnp.asarray(xb), nvalid, jnp.asarray(xq), k, metric, mask=jmask))
    gd, gp = got
    valid = np.arange(cap) < nvalid
    if mask is not None:
        valid &= mask
    assert (gp[gp >= 0] < nvalid).all() and valid[gp[gp >= 0]].all()
    assert (gp >= 0).sum(1).min() == min(k, valid.sum())


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_duplicate_rows_tie_by_position(metric):
    """Duplicated rows score exactly equal (small-integer data: every sum
    is exact) and rank by ascending position in both packages."""
    rng = np.random.default_rng(3)
    cap, nvalid, k = 256, 200, 6
    xb = np.zeros((cap, D), np.float32)
    xb[:nvalid] = rng.integers(-2, 3, (nvalid, D)).astype(np.float32)
    dup = [5, 17, 40, 41, 150]
    xb[dup] = xb[dup[0]]
    xq = np.repeat(xb[dup[0]][None] * 3, 8, 0)
    got = _port(xb, nvalid, xq, k, metric, None)
    _assert_same(got, pallas_flat_search(
        jnp.asarray(xb), nvalid, jnp.asarray(xq), k, metric, interpret=True))
    np.testing.assert_array_equal(got[1][:, :5], np.tile(dup, (8, 1)))


@pytest.mark.parametrize("n,k", [(300, 7), (8192, 40)])
def test_exact_topk_matches_jax(n, k):
    """Row-wise top-k of a wide score matrix (the JAX window-max path at
    n=8192) with many exact ties: equal values and indices."""
    rng = np.random.default_rng(n)
    scores = rng.integers(-50, 50, (6, n)).astype(np.float32)
    scores[:, ::5] = -np.inf
    vals, idx = exact_topk(torch.from_numpy(scores), k)
    jv, ji = jax_exact_topk(jnp.asarray(scores), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_wrapper_routes_cpu_tensors_to_plain_version():
    """CPU tensors never reach the kernel: no launch is counted."""
    xb, xq, _ = _inputs(1, 8, 256, 256, False)
    before = ft.LAUNCHES
    ft.flat_topk(torch.from_numpy(xb), 256, torch.from_numpy(xq), 4, "L2")
    assert ft.LAUNCHES == before


@pytest.mark.parametrize("xb_dev,xq_dev", [("meta", "meta"), ("cpu", "meta"),
                                           ("meta", "cpu")])
def test_wrapper_never_falls_back_off_the_cpu(xb_dev, xq_dev):
    """Only a pair of CPU tensors takes the plain version; any other pair
    goes to the kernel's checks, which refuse what is not on one CUDA
    device."""
    xb = torch.zeros((256, 8), device=xb_dev)
    xq = torch.zeros((4, 8), device=xq_dev)
    with pytest.raises(ValueError, match="same CUDA device"):
        ft.flat_topk(xb, 256, xq, 4, "L2")


@pytest.mark.parametrize("metric,k,d,ok", [
    ("L2", 1, 8, True),
    ("INNER_PRODUCT", 1024, 1536, True),
    ("L2", 1025, 128, False),
    ("L2", 0, 128, False),
    ("L1", 10, 128, False),
    ("L2", 1024, 8192, True),
])
def test_supports(metric, k, d, ok):
    assert ft.supports(metric, k, d) is ok


@pytest.mark.parametrize("nq,d,k,n_scan", [
    (64, 128, 10, 1_000_000), (1024, 128, 10, 1 << 20),
    (1, 1536, 1024, 1 << 20), (8, 8, 1, 1000), (16, 128, 100, 0)])
def test_plan_covers_corpus(nq, d, k, n_scan):
    """Splits tile [0, n_scan) in 128-row multiples; each query keeps k + m
    candidates with 64 slots of candidates beside them; the chosen query
    tile fits the 227 KB of shared memory a block can have; the merge has
    room for k + m sorted and 32 incoming."""
    p = ft.plan(nq, d, k, n_scan, n_sm=132)
    assert p["rows_per_split"] % 128 == 0
    assert p["splits"] * p["rows_per_split"] >= n_scan
    assert (p["splits"] - 1) * p["rows_per_split"] < max(n_scan, 1)
    assert p["k2"] == k + ft.margin(k) and ft.margin(k) >= 16
    assert p["qt"] in (8, 16, 32, 64)
    assert ft._partial_smem(p["qt"], p["slots"]) <= 227 * 1024
    assert p["slots"] >= p["k2"] + 64
    assert p["merge_slots"] >= p["k2"] + 32
    assert 8 * p["merge_warps"] * p["merge_slots"] <= 64 * 1024


# --- the 3xTF32 candidates and the exact rescore, emulated in plain torch --

def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """fp32 to TF32 (10 mantissa bits) by masking the 13 low bits: to
    nearest, ties away from zero, as cvt.rna.tf32.f32 does (half of the
    dropped bits added to the magnitude's bit pattern first), or truncated,
    as the kernel splits and as the tensor core reads an fp32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if nearest else 0)) & ~0x1FFF).view(torch.float32)


def _scores_3xtf32(xq: torch.Tensor, xb: torch.Tensor, metric: str,
                   nearest: bool = False):
    """The kernel's candidate scores: hi·lo + lo·hi + hi·hi in fp32, with
    the L2 expansion on fp32 norms."""
    qh, bh = _tf32(xq, nearest), _tf32(xb, nearest)
    ql, bl = _tf32(xq - qh, nearest), _tf32(xb - bh, nearest)
    dot = qh @ bl.T + ql @ bh.T + qh @ bh.T
    if metric == "INNER_PRODUCT":
        return dot
    qn = (xq * xq).sum(1, keepdim=True)
    bn = (xb * xb).sum(1)[None, :]
    return -(qn - 2.0 * dot + bn).clamp(min=0.0)


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("d", [8, 128, 1536])
def test_3xtf32_scores_within_the_bound(d, metric, nearest):
    """The split's scores, with TF32 by truncation (the kernel's) or to
    nearest, stay within ``error_bound`` of the float64 ones (the bound m
    is chosen from); one TF32 product alone breaks the split term of that
    bound, 3.01·2^-20·|q|·max|x| (2^-22 to nearest)."""
    rng = np.random.default_rng(d)
    xb = torch.from_numpy(rng.standard_normal((512, d)).astype(np.float32))
    xq = torch.from_numpy(rng.standard_normal((16, d)).astype(np.float32))
    got = _scores_3xtf32(xq, xb, metric, nearest).double()
    q64, b64 = xq.double(), xb.double()
    dot = q64 @ b64.T
    want = dot if metric == "INNER_PRODUCT" else -(
        (q64 * q64).sum(1, keepdim=True) - 2 * dot + (b64 * b64).sum(1))
    qn = (q64 * q64).sum(1, keepdim=True).numpy()
    bound = ft.error_bound(qn, float((b64 * b64).sum(1).max()), d, metric)
    err = (got - want).abs().numpy()
    assert (err <= bound).all()
    one = (_tf32(xq, nearest) @ _tf32(xb, nearest).T).double()
    split_term = 3.01 * 2.0 ** (-22 if nearest else -20) * np.sqrt(
        qn * float((b64 * b64).sum(1).max()))
    assert ((one - dot).abs().numpy() > split_term).any()


def _pipeline(xb, nvalid, xq, k, metric, mask, splits):
    """The kernel's two launches in plain torch: per split the best k + m
    rows by 3xTF32 score then position, the merge to the best k + m, the
    fp32 rescore of those rows, the final order."""
    k2 = k + ft.margin(k)
    valid = torch.arange(xb.shape[0]) < nvalid
    if mask is not None:
        valid &= mask
    approx = torch.where(valid[None, :], _scores_3xtf32(xq, xb, metric),
                         float("-inf"))
    pos = torch.arange(xb.shape[0], dtype=torch.int32).expand_as(approx)
    rows = -(-xb.shape[0] // splits)
    parts = [topk_ordered(approx[:, s:s + rows], pos[:, s:s + rows], k2)
             for s in range(0, xb.shape[0], rows)]
    cand_s, cand_p = topk_ordered(torch.cat([c[0] for c in parts], 1),
                                  torch.cat([c[1] for c in parts], 1), k2)
    live = torch.isfinite(cand_s)
    x = xb[cand_p.long().clamp(min=0)]
    dot = (x * xq[:, None, :]).sum(2)
    exact = dot if metric == "INNER_PRODUCT" else -(
        (xq * xq).sum(1, keepdim=True) - 2.0 * dot
        + (x * x).sum(2)).clamp(min=0.0)
    exact = torch.where(live, exact, float("-inf"))
    s, p = topk_ordered(exact, torch.where(live, cand_p, -1), k)
    return s, p.masked_fill(torch.isneginf(s), -1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 6, 40])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_candidates_then_rescore_equals_plain(metric, k, masked):
    """Candidates by 3xTF32 score, then the exact rescore, give the plain
    version's answer: duplicated rows (small-integer data, every sum
    exact) rank by position, with a mask and nvalid < cap."""
    rng = np.random.default_rng(k)
    cap, nvalid = 1000, 900
    xb = rng.integers(-3, 4, (cap, D)).astype(np.float32)
    dup = [3, 250, 251, 700, 899, 950]
    xb[dup] = xb[dup[0]]
    xq = rng.integers(-3, 4, (12, D)).astype(np.float32)
    xq[:3] = xb[dup[0]]
    mask = torch.from_numpy(rng.random(cap) < 0.6) if masked else None
    if mask is not None:
        mask[dup] = True
    xb_t, xq_t = torch.from_numpy(xb), torch.from_numpy(xq)
    for splits in (1, 7):
        got = _pipeline(xb_t, nvalid, xq_t, k, metric, mask, splits)
        want = ft.flat_topk_reference(xb_t, nvalid, xq_t, k, metric, mask)
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    if k >= 5:
        np.testing.assert_array_equal(got[1][:3, :5].numpy(),
                                      np.tile(dup[:5], (3, 1)))
