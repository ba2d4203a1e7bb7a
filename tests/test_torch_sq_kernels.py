"""The port's int8 IVF,SQ kernels (K2, K3, K5), their digit dot (K4) and
the SQ ops around them against the JAX package's.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs the Pallas kernels ``pallas_ivf_sq_search``,
``pallas_ivf_sq_pairs_search`` and ``pallas_spill_search`` in interpret
mode (as tests/test_pallas_topk.py and tests/test_pallas_pairs.py run
them), on the same padded code layout, probe table and queries, made from
numpy with a seed.  The JAX sq6 kernels read a plane-major copy of the
same codes, built here as models/ivf_layout.py builds it there.

Tolerances:

* codes, ranges, row sums and norms, tile tables: exact equality;
* query digits: the two packages take the per-query mean in another
  summation order, so a 15-bit digit ``128·hi + lo`` may differ by one;
* raw int8 scores (whose digits may so differ): 2e-5 of each row's scale,
  the largest of the terms its scores sum: its largest |score|, the
  query's ``base`` (‖q − vmin‖² for L2, |q·vmin| for inner product), the
  digit dot's bound Σ|u − μ|·levels, |μ|·Σc and, for L2, Σ(scale·c)² over
  the list's rows;
* searches, whose distances are rescored in fp32: distances rtol 1e-5 with
  atol 1e-5·max|distance|, positions equal wherever the neighbouring
  distances are further apart than that (as tests/test_torch_ivf_kernels.py).

The CUDA kernels themselves are held against these plain versions on the
card (chip_smoke.py, and the ``gpu``-marked cases in
tests/test_torch_package.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_faiss_ext_tpu.ops import ivf_scan as jax_scan
from duckdb_faiss_ext_tpu.ops import sq as jsq
from duckdb_faiss_ext_tpu.ops.pallas_ivf import pallas_ivf_sq_search
from duckdb_faiss_ext_tpu.ops.pallas_ivf_pairs import (
    pallas_ivf_sq_pairs_search)
from duckdb_faiss_ext_tpu.ops.pallas_spill import pallas_spill_search
from duckdb_faiss_ext_tpu_torch.ops import ivf_scan
from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
from duckdb_faiss_ext_tpu_torch.ops import sq as psq
from duckdb_faiss_ext_tpu_torch.ops import sq_digits
from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5
from duckdb_faiss_ext_tpu_torch.ops.ivf_pairs import QG

NLIST, LMAX = 8, 128
CODECS = ("sq8", "sq4", "sq6")
METRICS = ("L2", "INNER_PRODUCT")
RAW_TOL = 2e-5


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _encode(x, codec):
    """The port's ranges and packed codes of rows x."""
    vmin, scale = psq.sq_train(torch.from_numpy(x), psq.SQ_LEVELS[codec])
    q = psq.sq_quantize(torch.from_numpy(x), vmin, scale,
                        psq.SQ_LEVELS[codec]).numpy()
    return vmin.numpy(), scale.numpy(), psq.sq_pack(q, codec)


def _layout(seed, codec, d, nq, nprobe):
    """A padded (nlist, lmax, w) SQ code layout with one list at count ==
    lmax and one empty list, its rn / rs / row positions, the ranges, a
    probe table, queries and a mask."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(20, LMAX, NLIST).astype(np.int32)
    counts[1], counts[2] = LMAX, 0
    x = rng.standard_normal((int(counts.sum()), d)).astype(np.float32)
    vmin, scale, codes = _encode(x, codec)
    w = codes.shape[1]
    lists = np.zeros((NLIST, LMAX, w), np.uint8)
    row_pos = np.full((NLIST, LMAX), -1, np.int32)
    start = 0
    for li, c in enumerate(counts):
        lists[li, :c] = codes[start:start + c]
        row_pos[li, :c] = np.arange(start, start + c)
        start += c
    rn_all = psq.sq_row_norms(codes, scale, d, codec)
    rs_all = psq.sq_row_sums(codes, d, codec)
    rn = np.zeros((NLIST, LMAX), np.float32)
    rs = np.zeros((NLIST, LMAX), np.float32)
    valid = row_pos >= 0
    rn[valid] = rn_all[row_pos[valid]]
    rs[valid] = rs_all[row_pos[valid]]
    probe = np.stack([rng.choice(NLIST, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    probe[0, 0] = 2                                  # the empty list
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    mask = (rng.random((NLIST, LMAX)) < 0.6).astype(np.int8)
    return dict(lists=lists, rn=rn, rs=rs, counts=counts, row_pos=row_pos,
                vmin=vmin, scale=scale, probe=probe, xq=xq, mask=mask)


def _jax_lists(lists, codec):
    """The JAX sq6 kernels' plane-major (nlist, 3·lmax, w/3) payload."""
    if codec != "sq6":
        return lists
    nlist, lmax, w = lists.shape
    return np.ascontiguousarray(
        lists.reshape(nlist, lmax, w // 3, 3).transpose(0, 3, 1, 2)
    ).reshape(nlist, 3 * lmax, w // 3)


def _terms(L, q, lids, metric, codec):
    """Per (query q, list lids) pair, the largest term its raw scores sum
    (see the module docstring); q and lids broadcast together."""
    xq, vmin = L["xq"][q], L["vmin"]
    u = (xq - vmin) * L["scale"] if metric == "L2" else xq * L["scale"]
    mu = u.mean(-1, keepdims=True)
    terms = np.maximum(((xq - vmin) ** 2).sum(-1) if metric == "L2"
                       else np.abs(xq @ vmin),
                       np.abs(u - mu).sum(-1) * psq.SQ_LEVELS[codec])
    terms = np.maximum(terms, np.abs(mu[..., 0]) * L["rs"][lids].max(-1))
    if metric == "L2":
        terms = np.maximum(terms, L["rn"][lids].max(-1))
    return terms


def _assert_raw_agree(got, want, terms):
    """-inf slots equal; other scores within RAW_TOL of the row's scale."""
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isneginf(got), ~finite)
    scale = np.maximum(np.abs(np.where(finite, want, 0)).max(-1), terms)
    diff = np.where(finite, np.abs(np.where(finite, got, 0)
                                   - np.where(finite, want, 0)), 0).max(-1)
    assert (diff <= RAW_TOL * scale).all(), (diff / scale).max()


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


def _jax_pairs(L, codec, metric, mask, nprobe, **kw):
    return pallas_ivf_sq_pairs_search(
        *_j(_jax_lists(L["lists"], codec), L["rn"], L["rs"], L["counts"],
            L["row_pos"], L["vmin"], L["scale"], L["probe"], L["xq"], mask),
        nprobe=nprobe, metric=metric, codec=codec, interpret=True, **kw)


def _digits(L, codec, metric):
    w = L["lists"].shape[2]
    return sq_digits.query_digits(
        *_t(L["xq"], L["vmin"], L["scale"]), metric, codec, w,
        sq_digits.KERNEL_SHIFT[codec])


# --- codecs ----------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 33])
@pytest.mark.parametrize("codec", CODECS)
def test_codes_byte_equal_to_jax(codec, d):
    """Ranges, codes, packing, decode and the host row helpers equal the
    JAX package's from the same rows."""
    x = np.random.default_rng(d).standard_normal((300, d)).astype(
        np.float32) * 3
    vmin, scale, codes = _encode(x, codec)
    jv, js = jsq.sq_train(jnp.asarray(x), jsq.SQ_LEVELS[codec])
    np.testing.assert_array_equal(vmin, np.asarray(jv))
    np.testing.assert_array_equal(scale, np.asarray(js))
    q = np.asarray(jsq.sq_quantize(jnp.asarray(x), jv, js,
                                   levels=jsq.SQ_LEVELS[codec]))
    want = {"sq4": jsq.sq4_pack, "sq6": jsq.sq6_pack}.get(codec, np.asarray)(q)
    np.testing.assert_array_equal(codes, want)
    assert codes.shape[1] == psq.sq_code_width(d, codec) \
        == jsq.sq_code_width(d, codec)
    np.testing.assert_array_equal(
        psq.sq_unpack(torch.from_numpy(codes), codec).numpy()[:, :d], q)
    np.testing.assert_allclose(
        psq.sq_decode(*_t(codes, vmin, scale), codec).numpy(),
        np.asarray(jsq.sq_decode(*_j(codes, jv, js), codec)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(psq.sq_row_norms(codes, scale, d, codec),
                                  jsq.sq_row_norms(codes, js, d, codec))
    np.testing.assert_array_equal(psq.sq_row_sums(codes, d, codec),
                                  jsq.sq_row_sums(codes, d, codec))
    shifted = psq.sq_unpack_i8(torch.from_numpy(codes), d, codec).numpy()
    np.testing.assert_array_equal(
        shifted, np.asarray(jsq.sq_unpack_i8(jnp.asarray(codes), d, codec)))


@pytest.mark.parametrize("metric", METRICS)
def test_query_digits_match_jax(metric):
    """Digits within one 15-bit step of the JAX package's, scalars to fp32
    rounding, and the digits reproduce u − μ to half a step."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, 33)).astype(np.float32) * 2
    vmin, scale, _ = _encode(x, "sq8")
    xq = rng.standard_normal((64, 33)).astype(np.float32)
    u = (xq - vmin) * scale if metric == "L2" else xq * scale
    hi, lo, su2, mu, sut = (np.asarray(a) for a in jsq.sq_query_digits(
        jnp.asarray(u)))
    phi, plo, psu2, pmu, psut = (a.numpy() for a in psq.sq_query_digits(
        torch.from_numpy(u)))
    q15 = 128 * hi.astype(np.int32) + lo
    pq15 = 128 * phi.astype(np.int32) + plo
    assert np.abs(q15 - pq15).max() <= 1
    assert np.abs(plo).max() <= 64 and np.abs(phi).max() <= 127
    np.testing.assert_allclose(psu2, su2, rtol=1e-6)
    np.testing.assert_allclose(pmu, mu, rtol=1e-5, atol=1e-7)
    ut = u - pmu[:, None]
    assert (np.abs(psu2[:, None] * pq15 - ut)
            <= 0.5 * psu2[:, None] * (1 + 1e-5)).all()
    q = sq_digits.query_digits(*_t(xq, vmin, scale), metric, "sq8", 33, 128)
    assert q.digits.shape == (64, 2, sq_digits.digit_width(33, "sq8")) == (
        64, 2, 36)
    assert (q.digits[:, :, 33:] == 0).all()
    np.testing.assert_allclose(q.scalars[:, 1].numpy(), 128 * psut,
                               rtol=1e-6)


@pytest.mark.parametrize("codec", CODECS)
def test_digit_dot_is_exact(codec):
    """The plain K4 dot equals an integer dot of the unpacked codes and the
    digits, pad columns meeting zero digits."""
    rng = np.random.default_rng(5)
    d = 37
    x = rng.standard_normal((50, d)).astype(np.float32)
    _, _, codes = _encode(x, codec)
    w = codes.shape[1]
    width = sq_digits.digit_width(w, codec)
    dig = np.zeros((3, 2, width), np.int8)
    dig[:, :, :d] = rng.integers(-127, 128, (3, 2, d))
    shift = sq_digits.KERNEL_SHIFT[codec]
    got = sq_digits.digit_dots(
        torch.from_numpy(np.broadcast_to(codes, (3,) + codes.shape).copy()),
        torch.from_numpy(dig), codec, shift).numpy()
    c = psq.sq_unpack_host(codes, d, codec).astype(np.int64) - shift
    want = np.einsum("bsd,rd->bsr", dig[:, :, :d].astype(np.int64), c)
    np.testing.assert_array_equal(got, want)


# --- K3: pair tiles --------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec,d", [("sq8", 16), ("sq8", 33), ("sq4", 16),
                                     ("sq4", 33), ("sq6", 16), ("sq6", 33)])
def test_pairs_raw_tiles_match_jax(codec, d, metric, masked):
    """K3's plain raw tiles against the interpreted Pallas pair kernel's
    (``debug_raw``), real tiles only, dead slots -inf in both; the tile
    tables are integer-equal."""
    nq, nprobe = 16, 3
    L = _layout(d + len(codec), codec, d, nq, nprobe)
    mask = L["mask"] if masked else None
    raw, tl, tq, slot = (np.asarray(a) for a in _jax_pairs(
        L, codec, metric, mask, nprobe, k=5, k_scan=20, debug_raw=True))
    digits_t, scalars_t, meta, pair_slot = k3.sq_pair_tile_inputs(
        torch.from_numpy(L["probe"]), _digits(L, codec, metric), NLIST,
        metric)
    got = k3.ivf_sq_pairs_scan(
        *_t(L["lists"], L["rn"], L["rs"], L["counts"]), digits_t, scalars_t,
        meta, *_t(mask), metric, codec).numpy()
    n = int(meta[0])
    assert 0 < n < scalars_t.shape[0]
    np.testing.assert_array_equal(meta[1:n + 1].numpy(), tl[:n])
    np.testing.assert_array_equal(pair_slot.numpy(), slot)
    assert (tq[:n] < 0).any()                      # dead slots
    terms = _terms(L, np.clip(tq[:n], 0, None), tl[:n, None], metric, codec)
    _assert_raw_agree(got[:n], raw[:n], terms)
    assert np.isneginf(got[:n][tq[:n] < 0]).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_pairs_search_matches_jax(codec, metric):
    """K3's search (plain raw tiles, pair gather, top-k_scan, exact rerank)
    against ``pallas_ivf_sq_pairs_search``."""
    nq, nprobe, k = 16, 4, 7
    L = _layout(11, codec, 24, nq, nprobe)
    want = _jax_pairs(L, codec, metric, L["mask"], nprobe, k=k, k_scan=40)
    got = k3.ivf_sq_pairs_search(
        *_t(L["lists"], L["rn"], L["rs"], L["counts"], L["row_pos"],
            L["probe"], L["xq"], L["mask"], L["vmin"], L["scale"]),
        k=k, k_scan=40, metric=metric, codec=codec)
    _assert_topk_agree(got, want)


# --- K3 / K9: the kernels' host plan, their walk emulated -------------------

def walk_tiles(codes, rn, rs, counts, digits_t, scalars_t, meta, mask, metric,
               codec, plan, tensor_maps=None):
    """The pair-tile kernels' raw tiles, computed as the kernels walk them
    under the wrapper's ``plan`` (ops/ivf_sq_pairs.py::stage_plan) and, for
    K9's TMA copies, its ``tensor_maps`` (ops/ivf_sq_pairs_mega.py).  Each
    256-row x ``plan.chunk``-byte item is staged as the copies stage it
    (cp.async: the rows below the count; TMA: 64-row boxes of the codes'
    view up to the count, zeros out of bounds), the rest of the stage
    holding stale bytes (0xA5 here), with the digit slice of the chunk's
    dimensions (hi rows, then lo rows; cp.async: zero-filled past the
    width; TMA: 8-row boxes of the digit view, zeros out of bounds); exact
    int64 dots over the item's 32-dimension k-steps; the fp32 epilogue
    after a row chunk's last column chunk; whole row chunks past the count
    -inf.  Tiles at or past n_tiles are NaN (the kernels leave them
    unwritten)."""
    nlist, lmax, w = codes.shape
    rows_a, dims = k3.CHUNK_ROWS, plan.steps * k3.STEP_DIMS
    step = plan.chunk // plan.steps              # code bytes a k-step
    shift = sq_digits.KERNEL_SHIFT[codec]
    width = digits_t.shape[-1]
    if tensor_maps is None:
        box_h = rows_a
        # the digit rows, zero past the width, slot 2q + h as row h·8 + q
        pad = torch.zeros(digits_t.shape[0], 2, plan.col_chunks * dims,
                          dtype=torch.int64)
        pad[:, :, :width] = digits_t
        hi, lo = pad[:, 0], pad[:, 1]
    else:
        (cols, n_rows, stride, box_w, box_h), dmap = tensor_maps
        assert (box_w, stride) == (plan.chunk, w) and rows_a % box_h == 0
        view = codes.reshape(-1)[:n_rows * stride].reshape(n_rows, stride)
        view = view[:, :cols]
        dcols, drows, dstride, dbox_w, dbox_h = dmap
        assert (dbox_w, dbox_h, dcols) == (128, QG, width)
        flat = digits_t.reshape(-1)
        hi, lo = (torch.zeros(drows, plan.col_chunks * dims, dtype=torch.int64)
                  for _ in range(2))
        hi[:, :dcols] = torch.as_strided(flat, (drows, dcols), (dstride, 1))
        lo[:, :dcols] = torch.as_strided(flat, (drows, dcols), (dstride, 1),
                                         flat.storage_offset() + dcols)
    t_max = scalars_t.shape[0]
    out = torch.full((t_max, QG, lmax), float("nan"))
    for t in range(min(int(meta[0]), t_max)):
        lid = int(meta[1 + t])
        cnt = min(max(int(counts[lid]), 0), lmax) if 0 <= lid < nlist else 0
        dig = torch.cat([hi[t * QG:(t + 1) * QG], lo[t * QG:(t + 1) * QG]])
        tile = torch.full((QG, lmax), float("-inf"))
        for r0 in range(0, cnt, rows_a):
            acc = torch.zeros(2 * QG, rows_a, dtype=torch.int64)
            n = min(rows_a, cnt - r0)
            for cc in range(plan.col_chunks):
                c0 = cc * plan.chunk
                span = min(plan.chunk, w - c0)
                st = torch.full((rows_a, plan.chunk), 0xA5, dtype=torch.uint8)
                if tensor_maps is None:
                    st[:n, :span] = codes[lid, r0:r0 + n, c0:c0 + span]
                else:
                    boxed = -(-n // box_h) * box_h
                    st[:boxed] = 0
                    box = view[lid * lmax + r0:lid * lmax + r0 + boxed,
                               c0:c0 + plan.chunk]
                    st[:box.shape[0], :box.shape[1]] = box
                k = -(-span // step) * k3.STEP_DIMS     # dims of its k-steps
                c = psq.sq_unpack(st, codec).to(torch.int64) - shift
                acc += dig[:, cc * dims:cc * dims + k] @ c[:, :k].T
            rows = torch.arange(r0, min(r0 + rows_a, lmax))
            s = sq_digits.int8_scores(acc[:QG, :rows.numel()],
                                      acc[QG:, :rows.numel()],
                                      scalars_t[t][:, None, :],
                                      rs[lid, rows][None], rn[lid, rows][None],
                                      metric)
            live = rows < cnt
            if mask is not None:
                live &= mask[lid, rows] != 0
            tile[:, rows] = torch.where(live[None], s, float("-inf"))
        out[t] = tile
    return out


def test_stage_plan():
    """The plan the pair-tile kernels launch with: whole k-steps and
    16-byte pieces a chunk, enough chunks to cover a row; the shared memory
    within a block's, growing with the ring; the launch bounds' blocks an
    SM (K3 two, K9 one), then the deepest ring."""
    for codec, d in [("sq8", 16), ("sq8", 80), ("sq8", 1536), ("sq4", 33),
                     ("sq4", 1536), ("sq6", 33), ("sq6", 1536)]:
        w = psq.sq_code_width(d, codec)
        for persistent, tma, vec in [(False, False, True),
                                     (False, False, False),
                                     (True, False, True), (True, True, True)]:
            p = k3.stage_plan(w, codec, persistent=persistent, tma=tma,
                              vec=vec)
            assert p.chunk % 16 == 0 and p.chunk % k3.STEP_BYTES[codec] == 0
            assert p.steps == p.chunk // k3.STEP_BYTES[codec]
            assert p.col_chunks * p.chunk >= w > (p.col_chunks - 1) * p.chunk
            assert p.smem <= k3.SMEM_BLOCK_MAX
            blocks = 1 if persistent else 2
            assert blocks * (p.smem + k3.SMEM_RESERVED) <= k3.SMEM_SM
            assert p.stages <= (k3.MAX_STAGES_TMA if tma else k3.MAX_STAGES)
    p = k3.stage_plan(1536, "sq8", persistent=False)
    assert p.stages == 3 and 2 * (p.smem + k3.SMEM_RESERVED) <= k3.SMEM_SM
    assert k3.stage_plan(1536, "sq8", persistent=True, tma=True).stages == 6
    assert k3.stage_plan(1536, "sq8", persistent=True).stages == 4
    assert k3.stage_plan(1536, "sq8", persistent=True).smem > p.smem


@pytest.mark.parametrize("bad", ["codes", "rn", "rs", "mask", "lmax"])
def test_pair_layout_refuses_misaligned_inputs(bad):
    """``check_pair_layout``: the pair-tile kernels load rn / rs as float2,
    codes in 16-byte units and the mask in 2-byte pairs, so a view at an
    odd offset, or lmax not a multiple of 4, raises ValueError before any
    launch; the aligned tensors pass."""
    nlist, lmax, w = 3, 8, 32

    def shifted(n, dtype, by):
        return torch.zeros(n + by, dtype=dtype)[by:]

    t = dict(codes=torch.zeros(nlist, lmax, w, dtype=torch.uint8),
             rn=torch.zeros(nlist, lmax), rs=torch.zeros(nlist, lmax),
             mask=torch.ones(nlist, lmax, dtype=torch.int8))
    k3.check_pair_layout("scan", t["codes"], t["rn"], t["rs"], t["mask"])
    if bad == "lmax":
        t["codes"] = torch.zeros(nlist, lmax + 2, w, dtype=torch.uint8)
    else:
        src = t[bad]
        by = {"codes": 1, "rn": 1, "rs": 1, "mask": 2}[bad]
        t[bad] = shifted(src.numel(), src.dtype, by).view(src.shape)
    with pytest.raises(ValueError, match="aligned"):
        k3.check_pair_layout("scan", t["codes"], t["rn"], t["rs"], t["mask"])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("d", [16, 33, 80])
def test_k3_plan_walk_matches_jax(d, codec, metric, masked):
    """K3's plan, walked as the kernel walks it, gives the plain version's
    raw tiles bit for bit, and the interpreted Pallas pair kernel's
    (``debug_raw``, grid branch) within RAW_TOL."""
    nq, nprobe = 16, 3
    L = _layout(d + 7, codec, d, nq, nprobe)
    mask = L["mask"] if masked else None
    raw, tl, tq, _ = (np.asarray(a) for a in _jax_pairs(
        L, codec, metric, mask, nprobe, k=5, k_scan=20, debug_raw=True))
    digits_t, scalars_t, meta, _ = k3.sq_pair_tile_inputs(
        torch.from_numpy(L["probe"]), _digits(L, codec, metric), NLIST,
        metric)
    args = (*_t(L["lists"], L["rn"], L["rs"], L["counts"]), digits_t,
            scalars_t, meta, *_t(mask), metric, codec)
    plan = k3.stage_plan(L["lists"].shape[2], codec, persistent=False)
    got = walk_tiles(*args, plan)
    n = int(meta[0])
    assert torch.equal(got[:n], k3.ivf_sq_pairs_scan_reference(*args)[:n])
    terms = _terms(L, np.clip(tq[:n], 0, None), tl[:n, None], metric, codec)
    _assert_raw_agree(got[:n].numpy(), raw[:n], terms)


# --- K2: per-query list scan -------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_list_scan_raw_matches_jax_tiles(codec, metric, masked):
    """K2's plain raw (nq, nprobe, lmax) scores are the same scores as the
    interpreted pair kernel's tiles, gathered back through its
    ``pair_slot``."""
    nq, nprobe, d = 12, 3, 33
    L = _layout(7, codec, d, nq, nprobe)
    mask = L["mask"] if masked else None
    raw, _, _, slot = (np.asarray(a) for a in _jax_pairs(
        L, codec, metric, mask, nprobe, k=5, k_scan=20, debug_raw=True))
    want = raw.reshape(-1, LMAX)[slot.reshape(-1)].reshape(nq, nprobe, LMAX)
    q = _digits(L, codec, metric)
    got = k2.ivf_sq_scan(*_t(L["lists"], L["rn"], L["rs"], L["counts"],
                             L["probe"]), q.digits, q.scalars, *_t(mask),
                         metric, codec).numpy()
    terms = _terms(L, np.arange(nq)[:, None], L["probe"], metric, codec)
    _assert_raw_agree(got.reshape(-1, LMAX), want.reshape(-1, LMAX),
                      terms.reshape(-1))


@pytest.mark.parametrize("nprobe", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_list_search_matches_jax(codec, metric, masked, nprobe):
    """K2's search against the top-k ``pallas_ivf_sq_search`` returns, for
    k = 1, 10 and k beyond the valid candidates."""
    nq = 16
    L = _layout(nprobe + 20, codec, 32, nq, nprobe)
    mask = L["mask"] if masked else None
    args = (L["lists"], L["rn"], L["rs"], L["counts"], L["row_pos"],
            L["vmin"], L["scale"], L["probe"], L["xq"], mask)
    for k in (10, nprobe * LMAX):
        k_scan = min(nprobe * LMAX, max(4 * k, k + 32))
        ws, wp = pallas_ivf_sq_search(
            *_j(_jax_lists(args[0], codec), *args[1:]), k=k, k_scan=k_scan,
            nprobe=nprobe, metric=metric, codec=codec, interpret=True)
        got = k2.ivf_sq_list_search(
            *_t(L["lists"], L["rn"], L["rs"], L["counts"], L["row_pos"],
                L["probe"], L["xq"], mask, L["vmin"], L["scale"]),
            k=k, k_scan=k_scan, metric=metric, codec=codec)
        _assert_topk_agree(got, (ws, wp))
    assert np.isneginf(np.asarray(ws)[:, -1]).any()


# --- K5: spill windows -----------------------------------------------------

def _spill(seed, codec, d, s_pad, n_real, nlist, nq, nprobe):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s_pad, d)).astype(np.float32)
    vmin, scale, codes = _encode(x, codec)
    pos = np.where(np.arange(s_pad) < n_real,
                   rng.permutation(10 * s_pad)[:s_pad], -1).astype(np.int32)
    assign = rng.integers(0, nlist, s_pad).astype(np.int32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    return dict(codes=codes, assign=assign, pos=pos,
                rn=psq.sq_row_norms(codes, scale, d, codec),
                rs=psq.sq_row_sums(codes, d, codec), probe=probe,
                xq=rng.standard_normal((nq, d)).astype(np.float32),
                mask=rng.random(s_pad) < 0.7, vmin=vmin, scale=scale)


@pytest.mark.parametrize("nprobe", [1, 6])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", ["sq8", "sq4"])
def test_spill_search_matches_jax(codec, metric, masked, nprobe):
    """``sq_spill_search`` (plain window scan, both rerank legs) against
    ``pallas_spill_search`` on the same spill region, k = 10 and k beyond
    the windows (padded back)."""
    S = _spill(nprobe, codec, 20, 1024, 900, 12, 16, nprobe)
    mask = S["mask"] if masked else None
    for k in (10, 12):
        ws, wp = pallas_spill_search(
            *_j(S["codes"], S["assign"], S["pos"], S["probe"], S["xq"], mask),
            k=k, metric=metric, sq=codec, sq_vmin=jnp.asarray(S["vmin"]),
            sq_scale=jnp.asarray(S["scale"]), spill_rn=jnp.asarray(S["rn"]),
            spill_rs=jnp.asarray(S["rs"]), interpret=True,
            digit_dtype="int8")
        got = k5.sq_spill_search(
            *_t(S["codes"], S["assign"], S["pos"], S["rs"], S["rn"]), 1024,
            *_t(S["probe"], S["xq"], mask, S["vmin"], S["scale"]), k=k,
            metric=metric, codec=codec)
        assert got[0].shape == (16, k)
        _assert_topk_agree(got, (ws, wp))


@pytest.mark.parametrize("n_rows", [1000, 1024, 77])
@pytest.mark.parametrize("metric", METRICS)
def test_spill_windows_reference(metric, n_rows):
    """K5's plain (window max, first argmax) against a numpy loop over the
    windows of the first n_rows rows, the last window ragged."""
    codec = "sq4"
    S = _spill(3, codec, 24, 1024, 1000, 6, 9, 2)
    w = S["codes"].shape[1]
    q = sq_digits.query_digits(*_t(S["xq"], S["vmin"], S["scale"]), metric,
                               codec, w, 0)
    wmax, warg = k5.sq_spill_windows(
        *_t(S["codes"], S["assign"], S["pos"], S["rs"], S["rn"], S["mask"],
            S["probe"]), q.digits, q.scalars, n_rows, metric, codec)
    nwin = -(-n_rows // k5.WIN)
    assert wmax.shape == warg.shape == (9, nwin)
    c = psq.sq_unpack_host(S["codes"], 24, codec).astype(np.float64)
    dig = q.digits.numpy().astype(np.float64)[:, :, :24]
    hi, lo = dig[:, 0] @ c.T, dig[:, 1] @ c.T
    s = sq_digits.int8_scores(*_t(hi, lo), q.scalars[:, None, :],
                              *_t(S["rs"][None], S["rn"][None]),
                              metric).numpy()
    ok = ((S["probe"][:, :, None] == S["assign"][None, None]).any(1)
          & (S["pos"] >= 0) & S["mask"] & (np.arange(1024) < n_rows))
    s = np.where(ok, s, -np.inf)
    for v in range(nwin):
        blk = s[:, v * 128:(v + 1) * 128]
        np.testing.assert_array_equal(wmax[:, v].numpy(), blk.max(1))
        np.testing.assert_array_equal(warg[:, v].numpy(),
                                      v * 128 + blk.argmax(1))


def _legs_inline(codes, assign, pos, n_rows, probe_ids, xq, mask, vmin,
                 scale, wmax, warg, k, codec, metric):
    """The spill search's two rerank legs as ``sq_spill_search`` ran them
    inline before they became ``spill_rescore_reference``."""
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_decode

    nq, d = xq.shape
    s_pad = codes.shape[0]
    nwin = wmax.shape[1]
    k = min(k, nwin)
    f, add = (8, 96) if codec == "sq4" else (4, 32)
    k_scan = min(nwin, max(f * k, k + add))
    bestw, wsel = exact_topk(wmax, k_scan)
    kw = min(nwin, k + 2)
    parts_s = []
    lane = torch.arange(k5.WIN)
    rows_full = (wsel[:, :kw, None].long() * k5.WIN + lane).reshape(
        nq, kw * k5.WIN)
    s_full = torch.empty((nq, kw * k5.WIN), dtype=torch.float32)
    qb = max(1, (1 << 26) // max(kw * k5.WIN * d, 1))
    for q0 in range(0, nq, qb):
        rows = rows_full[q0:q0 + qb]
        safe = rows.clamp(max=s_pad - 1)
        n = rows.shape[0]
        xs = sq_decode(codes[safe.reshape(-1)], vmin, scale, codec) \
            .reshape(n, kw * k5.WIN, d)
        ok = (k5.probed(probe_ids[q0:q0 + qb], assign[safe])
              & (rows < n_rows) & (pos[safe] >= 0))
        if mask is not None:
            ok = ok & (mask[safe] != 0)
        s_full[q0:q0 + qb] = torch.where(
            ok, k5.spill_rerank_scores(xs, xq[q0:q0 + qb], metric),
            float("-inf"))
    parts_s.append(s_full)
    nt = k_scan - kw
    if nt:
        cand = warg.gather(1, wsel[:, kw:]).long()
        xs = sq_decode(codes[cand.reshape(-1)], vmin, scale, codec) \
            .reshape(nq, nt, d)
        parts_s.append(torch.where(torch.isneginf(bestw[:, kw:]),
                                   float("-inf"),
                                   k5.spill_rerank_scores(xs, xq, metric)))
    return torch.cat(parts_s, 1), (bestw, wsel, kw)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", ["sq8", "sq4"])
def test_spill_rescore_reference_equals_inline_legs(codec, metric, masked):
    """``spill_rescore_reference`` is the two legs the spill search ran
    inline, moved into a function: bit for bit the same scores, -inf in the
    same places."""
    S = _spill(5, codec, 20, 1024, 900, 12, 16, 6)
    mask = torch.from_numpy(S["mask"]) if masked else None
    codes, assign, pos, rs, rn, probe, xq, vmin, scale = _t(
        S["codes"], S["assign"], S["pos"], S["rs"], S["rn"], S["probe"],
        S["xq"], S["vmin"], S["scale"])
    q = sq_digits.query_digits(xq, vmin, scale, metric, codec,
                               codes.shape[1], sq_digits.KERNEL_SHIFT[codec])
    wmax, warg = k5.sq_spill_windows_reference(
        codes, assign, pos, rs, rn, mask, probe, q.digits, q.scalars, 900,
        metric, codec)
    want, (bestw, wsel, kw) = _legs_inline(
        codes, assign, pos, 900, probe, xq, mask, vmin, scale, wmax, warg,
        10, codec, metric)
    got = k5.spill_rescore_reference(codes, assign, pos, mask, 900, probe, xq,
                                     vmin, scale, bestw, wsel, warg, kw,
                                     metric, codec)
    assert torch.equal(got, want)
    assert torch.isneginf(got).any() and torch.isfinite(got).any()


def test_spill_offsets_bracket_sorted_lists():
    """``spill_offsets``: list l's rows are [offsets[l], offsets[l + 1]),
    empty lists included; an unsorted spill is refused."""
    assign = np.array([0, 0, 2, 2, 2, 5], np.int32)
    np.testing.assert_array_equal(k5.spill_offsets(assign, 7),
                                  [0, 2, 2, 5, 5, 5, 6, 6])
    with pytest.raises(ValueError, match="sorted"):
        k5.spill_offsets(assign[::-1], 7)


# --- the plain SQ scans around the kernels -----------------------------------

def _sorted_codes(seed, codec, d):
    rng = np.random.default_rng(seed)
    n, nlist = 700, 6
    assign = np.sort(rng.integers(0, nlist, n))
    counts = np.bincount(assign, minlength=nlist).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    vmin, scale, codes = _encode(x, codec)
    buf = np.zeros((1024, codes.shape[1]), np.uint8)
    buf[:n] = codes
    rn = np.zeros(1024, np.float32)
    rs = np.zeros(1024, np.float32)
    rn[:n] = psq.sq_row_norms(codes, scale, d, codec)
    rs[:n] = psq.sq_row_sums(codes, d, codec)
    return dict(codes=buf, rn=rn, rs=rs, offs=offs, counts=counts,
                cents=rng.standard_normal((nlist, d)).astype(np.float32),
                xq=rng.standard_normal((8, d)).astype(np.float32),
                mask=rng.random(1024) < 0.7, vmin=vmin, scale=scale)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_decode_gather_scan_matches_jax(codec, metric):
    """The parity path: the sorted+gather scan over decoded SQ codes, with
    a mask, against ``ivf_sq_search``."""
    G = _sorted_codes(2, codec, 17)
    got = ivf_scan.ivf_sq_search(
        *_t(G["codes"], G["vmin"], G["scale"], G["offs"], G["counts"],
            G["cents"], G["xq"], G["mask"]), 0.0, k=9, nprobe=3,
        metric=metric, q_chunk=4, codec=codec, lmax=256)
    want = jax_scan.ivf_sq_search(
        *_j(G["codes"], G["vmin"], G["scale"], G["offs"], G["counts"],
            G["cents"], G["xq"], G["mask"]), jnp.float32(0.0), k=9,
        nprobe=3, metric=metric, q_chunk=4, precision=None, codec=codec,
        lmax=256)
    _assert_topk_agree(got, want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_int8_gather_scan_matches_jax(codec, metric):
    """The int8 gather scan (no layout plan) against ``ivf_sq_int8_search``."""
    G = _sorted_codes(4, codec, 20)
    got = ivf_scan.ivf_sq_int8_search(
        *_t(G["codes"], G["rn"], G["rs"], G["offs"], G["counts"], G["cents"],
            G["vmin"], G["scale"], G["xq"], G["mask"]), 0.0, k=9, k_scan=40,
        nprobe=3, metric=metric, q_chunk=4, codec=codec, lmax=256)
    want = jax_scan.ivf_sq_int8_search(
        *_j(G["codes"], G["rn"], G["rs"], G["offs"], G["counts"], G["cents"],
            G["vmin"], G["scale"], G["xq"], G["mask"]), jnp.float32(0.0),
        k=9, k_scan=40, nprobe=3, metric=metric, q_chunk=4, precision=None,
        codec=codec, lmax=256)
    _assert_topk_agree(got, want)


@pytest.mark.parametrize("int8_dot", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_sq_spill_scan_matches_jax(codec, int8_dot):
    """The plain SQ spill scan (decoded rows, or int8 dots with a widened
    pool and the exact rerank) against the JAX package's."""
    S = _spill(8, codec, 20, 512, 450, 10, 8, 3)
    got = ivf_scan.ivf_spill_scan(
        *_t(S["codes"], S["assign"], S["pos"], S["probe"], S["xq"],
            S["mask"]), 0.0, k=6, metric="L2", nlist=10, sq=codec,
        sq_vmin=torch.from_numpy(S["vmin"]),
        sq_scale=torch.from_numpy(S["scale"]),
        spill_rn=torch.from_numpy(S["rn"]), spill_rs=torch.from_numpy(S["rs"]),
        int8_dot=int8_dot)
    want = jax_scan.ivf_spill_scan(
        *_j(S["codes"], S["assign"], S["pos"]), jnp.zeros((10, 20)), None,
        *_j(S["probe"], S["xq"], S["mask"]), jnp.float32(0.0), k=6,
        metric="L2", precision=None, sq=codec,
        sq_vmin=jnp.asarray(S["vmin"]), sq_scale=jnp.asarray(S["scale"]),
        spill_rn=jnp.asarray(S["rn"]), spill_rs=jnp.asarray(S["rs"]),
        int8_dot=int8_dot, int8_via="int32")
    _assert_topk_agree(got, want)


# --- wrappers: CPU tensors take the plain version, nothing else falls back

def test_wrappers_route_cpu_tensors_to_plain_versions():
    L = _layout(1, "sq8", 16, 4, 2)
    S = _spill(1, "sq8", 16, 256, 200, 8, 4, 2)
    before = (k2.LAUNCHES, k3.LAUNCHES, k5.LAUNCHES)
    args = _t(L["lists"], L["rn"], L["rs"], L["counts"], L["row_pos"],
              L["probe"], L["xq"], L["mask"], L["vmin"], L["scale"])
    k2.ivf_sq_list_search(*args, k=5, k_scan=20, metric="L2", codec="sq8")
    k3.ivf_sq_pairs_search(*args, k=5, k_scan=20, metric="L2", codec="sq8")
    k5.sq_spill_search(*_t(S["codes"], S["assign"], S["pos"], S["rs"],
                           S["rn"]), 200,
                       *_t(S["probe"], S["xq"], None, S["vmin"], S["scale"]),
                       k=5, metric="L2", codec="sq8")
    assert (k2.LAUNCHES, k3.LAUNCHES, k5.LAUNCHES) == before


@pytest.mark.parametrize("kernel,which", [
    ("k2", "codes"), ("k2", "digits"), ("k3", "codes"), ("k3", "meta"),
    ("k5", "codes"), ("k5", "probe_ids")])
def test_kernels_never_fall_back_off_the_cpu(kernel, which):
    """A tensor on a device the kernel cannot launch on raises before any
    score is computed."""
    L = _layout(1, "sq8", 16, 8, 2)
    S = _spill(1, "sq8", 16, 256, 200, 8, 8, 2)
    q = _digits(L, "sq8", "L2")
    if kernel == "k2":
        fn = k2.ivf_sq_scan
        args = dict(zip(("codes", "rn", "rs", "counts", "probe_ids"),
                        _t(L["lists"], L["rn"], L["rs"], L["counts"],
                           L["probe"])), digits=q.digits, scalars=q.scalars,
                    mask=None, metric="L2", codec="sq8")
    elif kernel == "k3":
        fn = k3.ivf_sq_pairs_scan
        dt_, st, meta, _ = k3.sq_pair_tile_inputs(
            torch.from_numpy(L["probe"]), q, NLIST, "L2")
        args = dict(zip(("codes", "rn", "rs", "counts"),
                        _t(L["lists"], L["rn"], L["rs"], L["counts"])),
                    digits_t=dt_, scalars_t=st, meta=meta, mask=None,
                    metric="L2", codec="sq8")
    else:
        fn = k5.sq_spill_windows
        args = dict(zip(("codes", "assign", "pos", "rs", "rn", "probe_ids"),
                        _t(S["codes"], S["assign"], S["pos"], S["rs"],
                           S["rn"], S["probe"])), mask=None,
                    digits=q.digits, scalars=q.scalars, n_rows=200,
                    metric="L2", codec="sq8")
    args[which] = args[which].to("meta")
    with pytest.raises(ValueError, match="same CUDA device"):
        fn(**args)


def test_pair_tile_inputs_mark_dead_slots():
    """Empty slots carry base +inf (L2) / -inf (IP); every real slot holds
    its query's digits and scalars."""
    L = _layout(9, "sq4", 16, 10, 3)
    for metric in METRICS:
        q = _digits(L, "sq4", metric)
        dt_, st, meta, _ = k3.sq_pair_tile_inputs(
            torch.from_numpy(L["probe"]), q, NLIST, metric)
        from duckdb_faiss_ext_tpu_torch.ops.ivf_pairs import build_pair_tiles

        _, tq, _, _ = build_pair_tiles(torch.from_numpy(L["probe"]),
                                       nlist=NLIST, t_max=st.shape[0])
        dead = tq < 0
        assert dead.any()
        want = float("inf") if metric == "L2" else float("-inf")
        assert (st[:, :, 2][dead] == want).all()
        live = tq.clamp(min=0).long()
        np.testing.assert_array_equal(
            st[:, :, [0, 1, 3]][~dead].numpy(),
            q.scalars[live][:, :, [0, 1, 3]][~dead].numpy())
        np.testing.assert_array_equal(
            dt_.reshape(-1, QG, 2, dt_.shape[-1])[~dead].numpy(),
            q.digits[live][~dead].numpy())
