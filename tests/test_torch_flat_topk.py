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
from duckdb_faiss_ext_tpu_torch.utils.config import next_pow2

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


def test_dense_counter_present_and_unchanged_on_cpu():
    """``kernels.flat_topk_dense`` is in ``faiss_stats()["counters"]`` from
    import; CPU tensors take the plain version and count nothing."""
    from duckdb_faiss_ext_tpu_torch.api import faiss_stats
    before = faiss_stats()["counters"][ft.DENSE_CALLS]
    xb, xq, _ = _inputs(2, 8, 256, 256, False)
    ft.flat_topk(torch.from_numpy(xb), 256, torch.from_numpy(xq), 4, "L2")
    assert faiss_stats()["counters"][ft.DENSE_CALLS] == before


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
    (1, 1536, 1024, 1 << 20), (8, 8, 1, 1000), (16, 128, 100, 0),
    (64, 1536, 15, 2048), (64, 128, 64, 4096), (1024, 128, 64, 4096)])
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


#: today's split plan of the Flat cells' shapes, which keep it
_SPLIT_1M = {"k2": 26, "splits": 131, "rows_per_split": 7680, "slots": 128,
             "merge_slots": 64, "merge_warps": 8}


@pytest.mark.parametrize("nq,n_scan,d,k,blocks", [
    (64, 2048, 1536, 15, 128), (64, 4096, 128, 64, 256),
    (1024, 4096, 128, 64, 512), (64, 1_000_000, 128, 10, None),
    (8, 1_000_000, 128, 10, None)])
def test_plan_regime(nq, n_scan, d, k, blocks):
    """The IVF coarse shapes (the marco table, IVF4096 at b48 and b1024)
    take the dense regime: a grid of ``blocks`` covering every (query,
    row), a wave of the card's 132 SMs or, at the marco table, the 128 of
    the smallest tile; its score tile within ``DENSE_SCRATCH``, |x|^2
    summed by the split partial's threads a row.  The 1M-row Flat shapes
    keep today's split plan exactly."""
    p = ft.plan(nq, d, k, n_scan, n_sm=132)
    if blocks is None:
        assert p["dense"] is None
        assert {key: p[key] for key in _SPLIT_1M} == _SPLIT_1M
        assert p["qt"] == min(64, nq)
        return
    dn = p["dense"]
    tq, tn = ft._DENSE_TILES[dn["tile"]]
    assert dn["grid"][0] * dn["grid"][1] == blocks
    assert blocks >= 132 or dn["tile"] == len(ft._DENSE_TILES) - 1
    assert dn["grid"][0] * tq >= nq > (dn["grid"][0] - 1) * tq
    assert dn["grid"][1] * tn >= n_scan > (dn["grid"][1] - 1) * tn
    assert 4 * nq * n_scan <= ft.DENSE_SCRATCH
    assert tn * dn["bn_parts"] <= ft._THREADS
    assert dn["bn_parts"] == ft._THREADS // ft._tile_rows(p["qt"])
    assert dn["ks"] == next_pow2(p["k2"]) and dn["buffer"] >= n_scan
    assert 4 * 256 + 8 * dn["ks"] + 4 * dn["buffer"] <= 227 * 1024
    # the largest tile that fills the wave: the next larger one does not
    if dn["tile"] > 0:
        lq, ln = ft._DENSE_TILES[dn["tile"] - 1]
        assert -(-nq // lq) * -(-n_scan // ln) < 132


@pytest.mark.parametrize("nq,n_scan,dense", [
    (1, 32768, True), (1, 32769, False), (1024, 16384, True),
    (1024, 16385, False), (64, 0, False)])
def test_plan_dense_domain(nq, n_scan, dense):
    """The dense regime's domain: 1 to ``DENSE_MAX_ROWS`` rows with the
    (nq, n_scan) score tile within ``DENSE_SCRATCH``."""
    assert (ft.plan(nq, 128, 10, n_scan, n_sm=132)["dense"] is not None
            ) is dense


def _order_key(s: torch.Tensor) -> torch.Tensor:
    """The select launch's key: an unsigned order of the scores (int64
    here), -0 keyed as +0."""
    b = torch.where(s == 0, torch.zeros_like(s), s).view(torch.int32)
    b = b.to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 1 << 31, 0xFFFFFFFF - b, b | 1 << 31)


def _radix_select(scores: torch.Tensor, valid: torch.Tensor, k2: int):
    """The select launch's choice for one query, in plain torch: 8-bit
    passes from the top, each keeping the bucket that holds the K2-th key,
    stopping where the whole bucket is needed; exact ties at the K2-th key
    taken by position.  Returns the chosen positions, sorted."""
    key = _order_key(scores)
    prefix = pmask = need = 0
    for shift in (24, 16, 8, 0):
        inb = valid & ((key & pmask) == prefix)
        hist = torch.bincount((key[inb] >> shift) & 255, minlength=256)
        if shift == 24:
            need = min(k2, int(hist.sum()))
        if need == 0:
            return torch.zeros(0, dtype=torch.int64)
        above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
        digit = int((above >= need).nonzero().max())
        need -= int(above[digit] - hist[digit])
        prefix |= digit << shift
        pmask |= 255 << shift
        if int(hist[digit]) == need:
            break
    m = key & pmask
    gt = (valid & (m > prefix)).nonzero().flatten()
    eq = (valid & (m == prefix)).nonzero().flatten()[:need]
    return torch.sort(torch.cat([gt, eq])).values


@pytest.mark.parametrize("case", ["random", "ties", "signed_zero", "inf",
                                  "short", "masked"])
def test_radix_select_keeps_the_split_candidates(case):
    """The dense regime's select keeps the same K2 rows as the split's
    partial and merge, the best by (score descending, position
    ascending): with exact ties at the K2-th score, -0 beside +0 (which
    ``better`` ties), -inf scores, fewer valid rows than K2, and a mask."""
    rng = np.random.default_rng(5)
    n, k2 = 3001, 80
    s = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) * 100
    valid = torch.ones(n, dtype=torch.bool)
    if case == "ties":
        s = torch.from_numpy(rng.integers(-5, 5, n).astype(np.float32))
    elif case == "signed_zero":
        s = torch.from_numpy(rng.integers(-2, 1, n).astype(np.float32))
        s[::3] = -0.0
    elif case == "inf":
        s[rng.random(n) < 0.99] = float("-inf")
    elif case == "short":
        valid[50:] = False
    elif case == "masked":
        valid = torch.from_numpy(rng.random(n) < 0.1)
    got = _radix_select(s, valid, k2)
    pos = torch.arange(n, dtype=torch.int32)
    want_s, want_p = topk_ordered(
        torch.where(valid, s, float("-inf"))[None],
        pos[None], min(k2, int(valid.sum())))
    want = torch.sort(want_p[0].long()).values
    np.testing.assert_array_equal(got.numpy(), want.numpy())


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
