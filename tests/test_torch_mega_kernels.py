"""The port's pipelined pair-tile routes (K9 and K10, ``pairs_impl="mega"``)
against the JAX package's mega-step kernels.

On CPU tensors the mega wrappers run their plain versions, which are K3's
and K7's (the same function); the JAX side runs
``pallas_ivf_sq_pairs_search(..., mega=True)`` and
``pallas_ivf_pairs_search(..., mega=True)`` in interpret mode, at the
shapes of tests/test_pallas_pairs.py's mega cases, on the same layout,
probe table and queries made from numpy with a seed.  The JAX sq6 kernel
reads a plane-major copy of the same codes, made on its side only.  Then
``config.pairs_impl = "mega"`` end to end: big IVF,SQ8 and IVF,Flat batches
go through the mega wrappers, with the grid path's results, held against
the JAX package's mega path on a carried index.

Tolerances: searches are rescored in fp32, so distances rtol 1e-5 with
atol 1e-5·max|distance|, positions equal wherever the neighbouring
distances are further apart than that; the JAX and port query digits may
differ by one 15-bit step (tests/test_torch_sq_kernels.py), so raw int8
tiles agree to 2e-5 of each row's largest |score| and |base|.  The mega and
grid routes of the port agree exactly.  The CUDA kernels themselves are
held against the plain versions on the card (chip_smoke.py and the
``gpu``-marked cases of tests/test_torch_package.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.models.ivf import IVFIndex as JaxIVF
from duckdb_faiss_ext_tpu.ops.pallas_ivf_pairs import (
    pallas_ivf_pairs_search, pallas_ivf_sq_pairs_search)
from duckdb_faiss_ext_tpu.utils.config import config as jax_config
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.models.ivf import IVFIndex
from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10
from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9
from duckdb_faiss_ext_tpu_torch.ops import sq as psq
from duckdb_faiss_ext_tpu_torch.ops import sq_digits
from test_torch_sq_kernels import (  # noqa: E402  (same test dir)
    _assert_raw_agree, _terms, walk_tiles)

#: tests/test_pallas_pairs.py's mega shapes
N, D, NLIST, LMAX, NPROBE, K, NQ = 600, 64, 8, 128, 4, 5, 20


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev
    dt.config.pairs_impl = "grid"
    dt.set_sq_dot("auto")
    dt.set_precision("parity")


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


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


def _sq_layout(codec, metric, seed=23, d=D):
    """test_pallas_pairs.py's SQ state (at width d), encoded by the port
    (byte-equal to the JAX package's codes): round-robin lists, a probe
    table, queries and a mask."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((N, d)).astype(np.float32)
    xq = rng.standard_normal((NQ, d)).astype(np.float32)
    vmin, scale = psq.sq_train(torch.from_numpy(xb), psq.SQ_LEVELS[codec])
    q = psq.sq_quantize(torch.from_numpy(xb), vmin, scale,
                        psq.SQ_LEVELS[codec]).numpy()
    codes = psq.sq_pack(q, codec)
    w = codes.shape[1]
    assign = np.arange(N) % NLIST
    lists = np.zeros((NLIST, LMAX, w), np.uint8)
    row_pos = np.full((NLIST, LMAX), -1, np.int32)
    counts = np.bincount(assign, minlength=NLIST).astype(np.int32)
    for li in range(NLIST):
        rows = np.nonzero(assign == li)[0]
        lists[li, :rows.size] = codes[rows]
        row_pos[li, :rows.size] = rows
    rn_all = psq.sq_row_norms(codes, scale.numpy(), d, codec)
    rs_all = psq.sq_row_sums(codes, d, codec)
    valid = row_pos >= 0
    rn = np.zeros((NLIST, LMAX), np.float32)
    rs = np.zeros((NLIST, LMAX), np.float32)
    rn[valid] = rn_all[row_pos[valid]]
    rs[valid] = rs_all[row_pos[valid]]
    probe = np.stack([rng.choice(NLIST, NPROBE, replace=False)
                      for _ in range(NQ)]).astype(np.int32)
    mask = (rng.random((NLIST, LMAX)) < 0.7).astype(np.int8)
    return dict(lists=lists, rn=rn, rs=rs, counts=counts, row_pos=row_pos,
                vmin=vmin.numpy(), scale=scale.numpy(), probe=probe, xq=xq,
                mask=mask)


def _plane_major(lists, codec):
    """The JAX sq6 kernels' (nlist, 3·lmax, w/3) payload of packed rows."""
    if codec != "sq6":
        return lists
    nlist, lmax, w = lists.shape
    return np.ascontiguousarray(
        lists.reshape(nlist, lmax, w // 3, 3).transpose(0, 3, 1, 2)
    ).reshape(nlist, 3 * lmax, w // 3)


def _jax_sq_mega(L, codec, metric, mask, **kw):
    return pallas_ivf_sq_pairs_search(
        *(jnp.asarray(a) if a is not None else None for a in (
            _plane_major(L["lists"], codec), L["rn"], L["rs"], L["counts"],
            L["row_pos"], L["vmin"], L["scale"], L["probe"], L["xq"], mask)),
        nprobe=NPROBE, metric=metric, codec=codec, interpret=True, mega=True,
        **kw)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["sq8", "sq4", "sq6"])
def test_k9_route_matches_jax_mega(codec, metric, masked):
    """``ivf_sq_pairs_search(..., mega=True)`` (K9's route) against the
    JAX package's interpreted mega-step kernel: raw tiles and results."""
    L = _sq_layout(codec, metric)
    mask = L["mask"] if masked else None
    raw, tl, tq, slot = (np.asarray(a) for a in _jax_sq_mega(
        L, codec, metric, mask, k=K, k_scan=2 * K, debug_raw=True))
    q = sq_digits.query_digits(*_t(L["xq"], L["vmin"], L["scale"]), metric,
                               codec, L["lists"].shape[2],
                               sq_digits.KERNEL_SHIFT[codec])
    digits_t, scalars_t, meta, pair_slot = k3.sq_pair_tile_inputs(
        torch.from_numpy(L["probe"]), q, NLIST, metric)
    got = k9.ivf_sq_pairs_mega_scan(
        *_t(L["lists"], L["rn"], L["rs"], L["counts"]), digits_t, scalars_t,
        meta, *_t(mask), metric, codec).numpy()
    n = int(meta[0])
    np.testing.assert_array_equal(meta[1:n + 1].numpy(), tl[:n])
    np.testing.assert_array_equal(pair_slot.numpy(), slot)
    finite = np.isfinite(raw[:n])
    np.testing.assert_array_equal(np.isneginf(got[:n]), ~finite)
    base = np.abs(scalars_t[:n, :, 2].numpy())
    scale = np.maximum(np.abs(np.where(finite, raw[:n], 0)).max(-1),
                       np.where(np.isinf(base), 0, base))
    diff = np.abs(np.where(finite, got[:n] - np.where(finite, raw[:n], 0),
                           0)).max(-1)
    assert (diff <= 2e-5 * scale).all()
    args = (*_t(L["lists"], L["rn"], L["rs"], L["counts"], L["row_pos"],
                L["probe"], L["xq"], mask, L["vmin"], L["scale"]),)
    kw = dict(k=K, k_scan=2 * K, metric=metric, codec=codec)
    got = k3.ivf_sq_pairs_search(*args, **kw, mega=True)
    _assert_topk_agree(got, _jax_sq_mega(L, codec, metric, mask, k=K,
                                         k_scan=2 * K))
    grid = k3.ivf_sq_pairs_search(*args, **kw)
    for a, b in zip(got, grid):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["sq8", "sq4", "sq6"])
@pytest.mark.parametrize("d", [16, 33, 80])
def test_k9_plan_walk_matches_jax_mega(d, codec, metric, masked):
    """K9's host plan walked as the kernel walks it, through its TMA
    tensor map where ``tma_ok`` takes the width and through the cp.async
    ring's staging always: the plain version's raw tiles bit for bit, and
    the interpreted mega-step kernel's within 2e-5 of each row's scale
    (tests/test_torch_sq_kernels.py's terms)."""
    L = _sq_layout(codec, metric, seed=23 + d, d=d)
    mask = L["mask"] if masked else None
    raw, tl, tq, _ = (np.asarray(a) for a in _jax_sq_mega(
        L, codec, metric, mask, k=K, k_scan=2 * K, debug_raw=True))
    q = sq_digits.query_digits(*_t(L["xq"], L["vmin"], L["scale"]), metric,
                               codec, L["lists"].shape[2],
                               sq_digits.KERNEL_SHIFT[codec])
    digits_t, scalars_t, meta, _ = k3.sq_pair_tile_inputs(
        torch.from_numpy(L["probe"]), q, NLIST, metric)
    codes = torch.from_numpy(L["lists"])
    args = (codes, *_t(L["rn"], L["rs"], L["counts"]), digits_t, scalars_t,
            meta, *_t(mask), metric, codec)
    n = int(meta[0])
    np.testing.assert_array_equal(meta[1:n + 1].numpy(), tl[:n])
    want = k3.ivf_sq_pairs_scan_reference(*args)[:n]
    w = codes.shape[2]
    tma = k9.tma_ok(codes, digits_t, codec)
    assert tma == (codec != "sq6" and w % 16 == 0)
    walks = [walk_tiles(*args, k3.stage_plan(
        w, codec, persistent=True, vec=k3.vec_ok(codes, codec)))]
    if tma:
        walks.append(walk_tiles(
            *args, k3.stage_plan(w, codec, persistent=True, tma=True),
            k9.tensor_maps(codes, digits_t)))
    for got in walks:
        assert torch.equal(got[:n], want)
    terms = _terms(L, np.clip(tq[:n], 0, None), tl[:n, None], metric, codec)
    _assert_raw_agree(walks[-1][:n].numpy(), raw[:n], terms)


@pytest.mark.parametrize("codec,d", [("sq8", 272), ("sq8", 300), ("sq4", 600),
                                     ("sq6", 200)])
def test_k9_plan_walk_over_many_chunks(codec, d):
    """Lists of 640 rows (three row chunks, the last partial) and rows of
    several column chunks (the last partial, misaligned at sq8 d = 300),
    counts 0, 1, lmax and across chunk edges: the walk under both copy
    plans equals the plain version bit for bit."""
    g = torch.Generator().manual_seed(d)
    nlist, lmax, nq, nprobe = 6, 640, 24, 2
    w = psq.sq_code_width(d, codec)
    codes = torch.randint(0, 256, (nlist, lmax, w), generator=g,
                          dtype=torch.uint8)
    counts = torch.tensor([0, 1, lmax, 255, 257, 513], dtype=torch.int32)
    rn = torch.rand(nlist, lmax, generator=g) * 100
    rs = torch.rand(nlist, lmax, generator=g) * 100
    mask = (torch.rand(nlist, lmax, generator=g) < 0.7).to(torch.int8)
    xq = torch.randn(nq, d, generator=g)
    vmin = torch.randn(d, generator=g)
    scale = torch.rand(d, generator=g) / 50 + 1e-3
    probe = torch.rand(nq, nlist, generator=g).argsort(1)[:, :nprobe] \
        .to(torch.int32).contiguous()
    for metric in ("L2", "INNER_PRODUCT"):
        q = sq_digits.query_digits(xq, vmin, scale, metric, codec, w,
                                   sq_digits.KERNEL_SHIFT[codec])
        digits_t, scalars_t, meta, _ = k3.sq_pair_tile_inputs(
            probe, q, nlist, metric)
        args = (codes, rn, rs, counts, digits_t, scalars_t, meta, mask,
                metric, codec)
        n = int(meta[0])
        want = k3.ivf_sq_pairs_scan_reference(*args)[:n]
        plan = k3.stage_plan(w, codec, persistent=True,
                             vec=k3.vec_ok(codes, codec))
        assert plan.col_chunks > 1
        assert torch.equal(walk_tiles(*args, plan)[:n], want)
        if k9.tma_ok(codes, digits_t, codec):
            plan = k3.stage_plan(w, codec, persistent=True, tma=True)
            assert torch.equal(walk_tiles(
                *args, plan, k9.tensor_maps(codes, digits_t))[:n], want)


def test_tensor_maps_and_tma_gate():
    """The TMA views: the payload as (nlist·lmax, w) bytes in 64-row
    boxes, the digit rows as t_max·8 hi rows 2·width bytes apart in 8-row
    boxes, both 128 bytes wide; TMA takes sq8 / sq4 at code and digit
    widths a multiple of 16 with 16-byte aligned codes and digits, and
    nothing else."""
    codes = torch.zeros(3, 512, 48, dtype=torch.uint8)
    dig = torch.zeros(16, 2, 48, dtype=torch.int8)
    assert k9.tensor_maps(codes, dig) == ((48, 3 * 512, 48, 128, 64),
                                          (48, 16, 96, 128, 8))
    assert k9.tma_ok(codes, dig, "sq8") and k9.tma_ok(codes, dig, "sq4")
    assert not k9.tma_ok(codes, dig, "sq6")
    assert not k9.tma_ok(torch.zeros(3, 512, 40, dtype=torch.uint8),
                         torch.zeros(16, 2, 40, dtype=torch.int8), "sq8")
    shifted = torch.zeros(codes.numel() + 16, dtype=torch.uint8)[1:]
    assert not k9.tma_ok(shifted[:codes.numel()].view(codes.shape), dig,
                         "sq8")
    shifted = torch.zeros(dig.numel() + 16, dtype=torch.int8)[4:]
    assert not k9.tma_ok(codes, shifted[:dig.numel()].view(dig.shape), "sq8")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_k10_route_matches_jax_mega(metric, masked):
    """``ivf_pairs_search(..., mega=True)`` (K10's route) against the JAX
    package's interpreted mega-step Flat kernel (test_pallas_pairs.py's
    case: 100 rows a list)."""
    rng = np.random.default_rng(31)
    xb = rng.standard_normal((NLIST, LMAX, D)).astype(np.float32)
    counts = np.full(NLIST, 100, np.int32)
    row_pos = np.arange(NLIST * LMAX, dtype=np.int32).reshape(NLIST, LMAX)
    row_pos[:, 100:] = -1
    xq = rng.standard_normal((NQ, D)).astype(np.float32)
    probe = np.stack([rng.choice(NLIST, NPROBE, replace=False)
                      for _ in range(NQ)]).astype(np.int32)
    mask = (rng.random((NLIST, LMAX)) < 0.7).astype(np.int8) if masked \
        else None
    want = pallas_ivf_pairs_search(
        *(jnp.asarray(a) if a is not None else None
          for a in (xb, counts, row_pos, probe, xq, mask)),
        k=K, k_scan=2 * K, nprobe=NPROBE, metric=metric, interpret=True,
        mega=True)
    args = _t(xb, counts, row_pos, probe, xq, mask)
    got = k7.ivf_pairs_search(*args, k=K, k_scan=2 * K, metric=metric,
                              mega=True)
    _assert_topk_agree(got, want)
    grid = k7.ivf_pairs_search(*args, k=K, k_scan=2 * K, metric=metric)
    for a, b in zip(got, grid):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tps", [4, 16])
def test_tile_count_not_a_multiple_of_tps(tps):
    """A batch whose real tile count is not a multiple of the JAX kernel's
    tiles per step: the JAX mega kernel leaves its last step partly idle;
    the port's route (persistent blocks, no steps) gives the same
    results."""
    L = _sq_layout("sq8", "L2", seed=41)
    probe = L["probe"]
    q = sq_digits.query_digits(*_t(L["xq"], L["vmin"], L["scale"]), "L2",
                               "sq8", L["lists"].shape[2], 128)
    _, _, meta, _ = k3.sq_pair_tile_inputs(torch.from_numpy(probe), q, NLIST,
                                           "L2")
    assert int(meta[0]) % tps != 0
    want = _jax_sq_mega(L, "sq8", "L2", None, k=K, k_scan=2 * K,
                        tps_opt=tps)
    got = k3.ivf_sq_pairs_search(
        *_t(L["lists"], L["rn"], L["rs"], L["counts"], L["row_pos"], probe,
            L["xq"], None, L["vmin"], L["scale"]),
        k=K, k_scan=2 * K, metric="L2", codec="sq8", mega=True)
    _assert_topk_agree(got, want)


def _count_calls(monkeypatch, module, name):
    """Wrap ``module.name`` so the calls through it are counted."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("factory,metric", [("IVF64,SQ8", "L2"),
                                            ("IVF64,Flat", "INNER_PRODUCT")])
def test_pairs_impl_mega_end_to_end(catalog, monkeypatch, factory, metric):
    """``pairs_impl = "mega"`` routes big-batch IVF,SQ8 and IVF,Flat serving
    through K9's / K10's wrapper, with the grid path's results, held
    against the JAX package's mega path on a carried index
    (test_pallas_pairs.py's end-to-end case)."""
    rng = np.random.default_rng(37)
    n, d, nq = 20000, 32, 256
    xb = rng.standard_normal((n, d)).astype(np.float32)
    xq = xb[:nq] + 0.01 * rng.standard_normal((nq, d)).astype(np.float32)
    dfx.faiss_create("pm", d, factory, metric_type=metric, catalog=catalog)
    dfx.faiss_add(xb, "pm", catalog=catalog)
    pcat = dt.Catalog()
    pcat.put("pm", from_reference(catalog.get("pm")))
    sq = "SQ" in factory
    mega_calls = _count_calls(monkeypatch, k9 if sq else k10,
                              "ivf_sq_pairs_mega_scan" if sq
                              else "ivf_pairs_mega_scan")
    grid_calls = _count_calls(monkeypatch, k3 if sq else k7,
                              "ivf_sq_pairs_scan" if sq else "ivf_pairs_scan")
    params = {"nprobe": "8"}
    monkeypatch.setattr(IVFIndex, "PAIRS_MIN_WORK", 0)
    monkeypatch.setattr(JaxIVF, "PAIRS_MIN_WORK", 0)
    dt.set_precision("fast")
    idx = pcat.get("pm").index
    grid = dt.faiss_search("pm", K, xq, params, catalog=pcat)
    assert idx._last_scan_path == ("pairs-sq8" if sq else "pairs-flat")
    dt.config.pairs_impl = "mega"
    mega = dt.faiss_search("pm", K, xq, params, catalog=pcat)
    assert idx._last_scan_path == ("pairs-mega-sq8" if sq
                                   else "pairs-mega-flat")
    assert (len(grid_calls), len(mega_calls)) == (1, 1)
    np.testing.assert_array_equal(mega["label"], grid["label"])
    np.testing.assert_array_equal(mega["distance"], grid["distance"])
    dfx.set_kernel_mode("pallas")
    dfx.set_precision("fast")
    jax_config.pairs_impl = "mega"
    try:
        want = dfx.faiss_search("pm", K, xq, params, catalog=catalog)
    finally:
        jax_config.pairs_impl = "grid"
        dfx.set_kernel_mode("auto")
        dfx.set_precision("parity")
    assert catalog.get("pm").index._last_scan_path in (
        ("pairs-sq8", "fused-pairs-sq8") if sq else ("pairs-flat",))
    _assert_topk_agree((mega["distance"] * (-1 if metric == "L2" else 1),
                        mega["label"]),
                       (want["distance"] * (-1 if metric == "L2" else 1),
                        want["label"]))
