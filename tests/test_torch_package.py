"""Package-level properties of duckdb_faiss_ext_tpu_torch.

* it imports and searches without JAX;
* asking for the CUDA device where torch sees no card raises, instead of
  running on the CPU;
* the kernel build finds nvcc or raises, and names the library by a hash
  of the sources and the headers they include;
* on the card (``-m gpu``), the CUDA kernels (flat top-k, IVF list scan
  and the fused IVF,Flat (padded and unpadded layouts) and IVF,SQ list
  searches, IVF pair tiles, the
  int8 IVF,SQ list scan, pair tiles and spill windows,
  the IVF-PQ / IVF-RQ list search, the pipelined pair tiles K9 / K10, and
  the fused pair-tile IVF,Flat searches K7 / K10) match their plain
  versions, K1's dense and split regimes return the same bits, the IVF
  coarse stage runs K1's dense regime, and the IVF-PQ list search
  raises on inputs it does not take;
  the standalone SQ index's int8 scan (plain torch, its integer dots by
  ``torch._int_mm``) gives on card tensors what it gives on CPU tensors.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
from duckdb_faiss_ext_tpu_torch.ops import sq as psq
from duckdb_faiss_ext_tpu_torch.utils import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_and_searches_without_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import duckdb_faiss_ext_tpu_torch as dt
        dt.set_device("cpu")
        xb = np.random.default_rng(0).standard_normal((50, 4)).astype("f4")
        dt.faiss_create("i", 4, "IDMap,Flat", metric_type="L2")
        dt.faiss_add((np.arange(50) + 7, xb), "i")
        res = dt.faiss_search("i", 3, xb[:2])
        assert res["label"][:, 0].tolist() == [7, 8], res
        dt.faiss_create("v", 4, "IDMap,IVF2,Flat", metric_type="L2")
        dt.faiss_add((np.arange(50) + 7, xb), "v")
        res = dt.faiss_search("v", 3, xb[:2], {"nprobe": "2"})
        assert res["label"][:, 0].tolist() == [7, 8], res
        from duckdb_faiss_ext_tpu_torch.ops import (ivf_pairs_mega,
                                                    ivf_sq_pairs_mega)
        dt.config.pairs_impl = "mega"
        dt.faiss_create("s", 4, "IVF2,SQ8", metric_type="L2")
        dt.faiss_train_device(xb, "s")
        dt.faiss_add_device(xb, "s", expected_total=50)
        res = dt.faiss_search("s", 3, xb[:2], {"nprobe": "2"})
        assert res["label"][:, 0].tolist() == [0, 1], res
        import importlib, pkgutil
        import duckdb_faiss_ext_tpu_torch.examples as ex
        import duckdb_faiss_ext_tpu_torch.tools as tools
        for pkg in (tools, ex):
            for m in pkgutil.iter_modules(pkg.__path__):
                importlib.import_module(pkg.__name__ + "." + m.name)
        importlib.import_module("duckdb_faiss_ext_tpu_torch.sql.duckdb_bridge")
        assert not [m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "duckdb_faiss_ext_tpu")]
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_name_no_jax():
    """No source file of the port, its tools and examples included, nor
    chip_smoke.py, imports JAX or the JAX package."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|duckdb_faiss_ext_tpu)"
                     r"(\.|\s|$)", re.M)
    root = os.path.join(REPO, "duckdb_faiss_ext_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, _, names in os.walk(root):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert any("/tools/" in f for f in files)
    assert any("/examples/" in f for f in files)
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    prev = dt.config.device
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            dt.set_device("cuda")
        dt.config.device = "cuda"
        cat = dt.Catalog()
        with pytest.raises(RuntimeError, match="device 'cuda'"):
            dt.faiss_create("c", 4, "Flat", catalog=cat)
        assert cat.names() == []
    finally:
        dt.config.device = prev


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed in /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


def test_library_named_by_source_hash(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one")
    first = kernels._library_path([a])
    assert first.parent == kernels.BUILD_DIR
    assert first == kernels._library_path([a])
    a.write_text("// two")
    assert kernels._library_path([a]) != first


def test_library_hash_covers_headers(tmp_path):
    """Editing a header's bytes renames the library, so a stale build is
    never loaded; the package's own headers are among the hashed files."""
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"')
    hdr.write_text("// one")
    first = kernels._library_path([src, hdr])
    hdr.write_text("// two")
    assert kernels._library_path([src, hdr]) != first
    sources, headers = kernels._kernel_files()
    assert {p.name for p in headers} >= {"sq_digits.cuh"}
    assert {p.name for p in headers} >= {"cp_async.cuh"}
    assert {p.name for p in sources} >= {"ivf_sq_scan.cu", "ivf_sq_pairs.cu",
                                         "sq_spill.cu", "ivf_pq_scan.cu",
                                         "ivf_sq_pairs_mega.cu",
                                         "ivf_pairs_mega.cu"}


def test_build_dir_is_ignored_by_git():
    """The kernel library is built at run time, never committed."""
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = {line.strip() for line in f}
    assert kernels.BUILD_DIR.name == "build" and "build/" in lines


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("nq,d,k", [(1, 8, 1), (48, 128, 10), (64, 1536, 1024)])
def test_kernel_matches_plain_on_card(metric, nq, d, k):
    """The CUDA kernel against its plain torch version on the same card
    tensors; distances within 1e-5 relative to the largest score,
    positions equal wherever neighbouring scores are further apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    g = torch.Generator(device="cuda").manual_seed(0)
    cap, nvalid = 8192, 8000
    xb = torch.randn(cap, d, device="cuda", generator=g)
    xq = torch.randn(nq, d, device="cuda", generator=g)
    mask = torch.rand(cap, device="cuda", generator=g) < 0.5
    before = ft.LAUNCHES
    s, p = ft.flat_topk(xb, nvalid, xq, k, metric, mask)
    torch.cuda.synchronize()
    assert ft.LAUNCHES == before + 1
    rs, rp = ft.flat_topk_reference(xb, nvalid, xq, k, metric, mask)
    s, p, rs, rp = (t.cpu().numpy() for t in (s, p, rs, rp))
    tol = 1e-5 * np.abs(rs[np.isfinite(rs)]).max()
    np.testing.assert_allclose(s, rs, rtol=0, atol=tol)
    gap = np.diff(rs, axis=1)
    separated = np.ones_like(rs, bool)
    separated[:, 1:] &= np.abs(gap) > 2 * tol
    separated[:, :-1] &= np.abs(gap) > 2 * tol
    np.testing.assert_array_equal(p[separated], rp[separated])


def _rows_agree(got, want, qn):
    """-inf slots equal; other scores within 1e-5 of each row's scale (the
    larger of its largest |score| and |q|^2)."""
    g, w, qn = got.cpu().numpy(), want.cpu().numpy(), qn.cpu().numpy()
    finite = np.isfinite(w)
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
    tol = 1e-5 * np.maximum(np.abs(np.where(finite, w, 0)).max(1), qn)
    diff = np.abs(np.where(finite, g, 0) - np.where(finite, w, 0))
    assert (diff <= tol[:, None]).all(), diff.max()


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("d,nprobe", [(8, 1), (128, 3), (1536, 16)])
def test_ivf_kernels_match_plain_on_card(metric, d, nprobe):
    """K6 (per-query list scan) and K7 (pair tiles) against their plain
    torch versions on the same card tensors, raw scores element by element,
    with a mask, an empty list and a full one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    g = torch.Generator(device="cuda").manual_seed(1)
    nlist, lmax, nq = 16, 256, 64
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    lists = torch.randn(nlist, lmax, d, device="cuda", generator=g)
    lists *= (torch.arange(lmax, device="cuda")[None, :]
              < counts[:, None])[:, :, None]
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    before = (k6.LAUNCHES, k7.LAUNCHES)
    raw = k6.ivf_list_scan(lists, counts, probe, xq, mask, metric)
    torch.cuda.synchronize()
    ref = k6.ivf_list_scan_reference(lists, counts, probe, xq, mask, metric)
    _rows_agree(raw.reshape(-1, lmax), ref.reshape(-1, lmax),
                (xq * xq).sum(1).repeat_interleave(nprobe))
    xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq, nlist)
    raw = k7.ivf_pairs_scan(lists, counts, xq_t, qs_t, meta, mask, metric)
    torch.cuda.synchronize()
    ref = k7.ivf_pairs_scan_reference(lists, counts, xq_t, qs_t, meta, mask,
                                      metric)
    n = int(meta[0])
    _rows_agree(raw[:n].reshape(-1, lmax), ref[:n].reshape(-1, lmax),
                qs_t[:n, :, 1].reshape(-1))
    assert (k6.LAUNCHES, k7.LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,d", [("sq8", 33), ("sq8", 1536), ("sq4", 33),
                                     ("sq4", 128), ("sq6", 33),
                                     ("sq6", 1536)])
def test_sq_kernels_match_plain_on_card(codec, d, metric):
    """K2 (int8 list scan), K3 (pair tiles) and, for sq8 / sq4, K5 (spill
    windows) against their plain torch versions on the same card tensors,
    raw scores element by element (both apply the same fp32 epilogue to
    exact integer dots), with a mask, an empty list and a full one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_code_width
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    g = torch.Generator(device="cuda").manual_seed(2)
    nlist, lmax, nq, nprobe = 16, 256, 64, 3
    w = sq_code_width(d, codec)
    codes = torch.randint(0, 256, (nlist, lmax, w), device="cuda",
                          generator=g, dtype=torch.uint8)
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    rn = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    rs = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    vmin = torch.randn(d, device="cuda", generator=g)
    scale = torch.rand(d, device="cuda", generator=g) / 50 + 1e-3
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    before = (k2.LAUNCHES, k3.LAUNCHES, k5.LAUNCHES)
    raw = k2.ivf_sq_scan(codes, rn, rs, counts, probe, q.digits, q.scalars,
                         mask, metric, codec)
    torch.cuda.synchronize()
    ref = k2.ivf_sq_scan_reference(codes, rn, rs, counts, probe, q.digits,
                                   q.scalars, mask, metric, codec)
    _rows_agree(raw.reshape(-1, lmax), ref.reshape(-1, lmax),
                q.scalars[:, 2].abs().repeat_interleave(nprobe))
    dig_t, sc_t, meta, _ = k3.sq_pair_tile_inputs(probe, q, nlist, metric)
    raw = k3.ivf_sq_pairs_scan(codes, rn, rs, counts, dig_t, sc_t, meta,
                               mask, metric, codec)
    torch.cuda.synchronize()
    ref = k3.ivf_sq_pairs_scan_reference(codes, rn, rs, counts, dig_t, sc_t,
                                         meta, mask, metric, codec)
    n = int(meta[0])
    _rows_agree(raw[:n].reshape(-1, lmax), ref[:n].reshape(-1, lmax),
                sc_t[:n, :, 2].abs().nan_to_num(posinf=0).reshape(-1))
    launched = (1, 1, 0)
    if codec in k5.CODECS:
        flat = codes.reshape(-1, w)
        s_pad = flat.shape[0]
        assign = torch.randint(0, nlist, (s_pad,), device="cuda", generator=g,
                               dtype=torch.int32).sort().values
        offsets = torch.from_numpy(k5.spill_offsets(
            assign[:s_pad - 77].cpu().numpy(), nlist)).cuda()
        pos = torch.arange(s_pad, device="cuda", dtype=torch.int32)
        args = (flat, assign, pos, rs.reshape(-1), rn.reshape(-1),
                mask.reshape(-1), probe, q.digits, q.scalars, s_pad - 77,
                metric, codec, offsets)
        wmax, warg = k5.sq_spill_windows(*args)
        torch.cuda.synchronize()
        rmax, rarg = k5.sq_spill_windows_reference(*args)
        assert torch.equal(warg, rarg) and torch.equal(wmax, rmax)
        launched = (1, 1, 1)
    assert (k2.LAUNCHES - before[0], k3.LAUNCHES - before[1],
            k5.LAUNCHES - before[2]) == launched


def _live_row_pos(counts, lmax):
    live = torch.arange(lmax, device=counts.device)[None, :] < counts[:, None]
    start = torch.cumsum(counts, 0) - counts
    return torch.where(live, start[:, None] + torch.arange(
        lmax, device=counts.device)[None, :], -1).to(torch.int32)


def _assert_search_close(got, want, xq):
    """A list search's (scores, positions) against its plain version's:
    scores within 1e-5 of each query's scale, positions equal where
    neighbouring scores are further apart.  Returns the positions."""
    s, p, rs, rp = (t.cpu().numpy() for t in (*got, *want))
    finite = np.isfinite(rs)
    np.testing.assert_array_equal(np.isfinite(s), finite)
    tol = 1e-5 * np.maximum(np.abs(np.where(finite, rs, 0)).max(1),
                            (xq * xq).sum(1).cpu().numpy())
    assert (np.abs(np.where(finite, s - rs, 0)) <= tol[:, None]).all()
    gap = np.abs(np.diff(np.where(finite, rs, -1e30), axis=1)) \
        > 2 * tol[:, None]
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(p[sep], rp[sep])
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("d,k", [(8, 1), (128, 10), (1536, 100)])
def test_fused_list_search_matches_plain_on_card(d, k, metric):
    """The fused K6 (partial and merge launches) against its plain version
    on the same card tensors: scores within 1e-5 of each query's scale,
    positions equal where neighbouring scores are further apart; above
    its k limit the raw launch serves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6

    g = torch.Generator(device="cuda").manual_seed(4)
    nlist, lmax, nq, nprobe = 16, 256, 64, 5
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    lists = torch.randn(nlist, lmax, d, device="cuda", generator=g)
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    args = (lists, counts, _live_row_pos(counts, lmax), probe, xq, mask)
    before = (k6.LAUNCHES, k6.TOPK_LAUNCHES)
    got = k6.ivf_list_search(*args, k=k, metric=metric)
    torch.cuda.synchronize()
    _assert_search_close(got, k6.ivf_list_search_reference(
        *args, k=k, metric=metric), xq)
    k6.ivf_list_search(*args, k=k6.MAX_K + 1, metric=metric)
    assert (k6.LAUNCHES, k6.TOPK_LAUNCHES) == (before[0] + 1, before[1] + 1)


def _unpadded(counts, n_rows, g):
    """An unpadded layout's (offsets, row_pos) for ``counts``: each list's
    slots a random draw of distinct storage rows, in no order."""
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                          device=counts.device)
    offsets[1:] = torch.cumsum(counts.long(), 0)
    n = int(offsets[-1])
    rows = torch.randperm(n_rows, device=counts.device, generator=g)[:n]
    return offsets.to(torch.int32), rows.to(torch.int32).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("d,k,shift", [(8, 1, 0), (30, 10, 0), (128, 10, 1),
                                       (1536, 100, 0)])
def test_fused_list_search_unpadded_matches_plain_on_card(d, k, shift,
                                                          metric):
    """The fused K6 over the unpadded layout (rows in storage order, each
    list's slots through offsets and row_pos, the mask aligned with them)
    against its plain version on the same card tensors, as the padded
    case above: per-row bulk copies at d 8 / 1536, 4-byte copies where rows
    are not 16-byte aligned (d 30, and a payload shifted by one float);
    above its k limit the raw launch over the same layout serves, and its
    raw scores match the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6

    g = torch.Generator(device="cuda").manual_seed(5)
    nlist, lmax, nq, nprobe = 16, 300, 64, 5
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    n_rows = int(counts.sum()) + 500
    store = torch.randn(n_rows * d + shift, device="cuda", generator=g)
    lists = store[shift:].view(n_rows, d)
    offsets, row_pos = _unpadded(counts, n_rows, g)
    mask = (torch.rand(row_pos.shape[0], device="cuda", generator=g)
            < 0.6).to(torch.int8)
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    args = (lists, counts, row_pos, probe, xq, mask)
    layout = dict(offsets=offsets, lmax=lmax)
    before = (k6.LAUNCHES, k6.TOPK_LAUNCHES)
    passing = set(row_pos[mask != 0].cpu().tolist())
    for kk in (k, k6.MAX_K + 1):
        got = k6.ivf_list_search(*args, k=kk, metric=metric, **layout)
        torch.cuda.synchronize()
        p = _assert_search_close(got, k6.ivf_list_search_reference(
            *args, k=kk, metric=metric, **layout), xq)
        assert set(p[p >= 0].tolist()) <= passing
    assert (k6.LAUNCHES, k6.TOPK_LAUNCHES) == (before[0] + 1, before[1] + 1)
    raw = k6.ivf_list_scan(lists, counts, probe, xq, mask, metric,
                           row_pos=row_pos, **layout)
    want = k6.ivf_list_scan_reference(lists, counts, probe, xq, mask, metric,
                                      row_pos=row_pos, **layout)
    assert torch.equal(torch.isneginf(raw), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(raw[live], want[live], rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("d,shift", [(30, 0), (128, 1), (1536, 0)])
@pytest.mark.parametrize("rate", [0.0, 0.1, 1.0])
def test_pass_index_search_equals_masked_on_card(rate, d, shift, metric):
    """K6 over a mask's pass index (models/ivf_layout.py::pass_index, no
    mask) returns bit for bit what K6 over the full unpadded layout with
    the mask returns: at k 10 (the fused search) and k 1025 (the raw
    launch), pass rates 0 (an empty index), 10% and 100%, every row stored
    twice so that equal scores must resolve to the same rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    from duckdb_faiss_ext_tpu_torch.models.ivf_layout import (UnpaddedLayout,
                                                              pass_index)
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops.list_topk import pad_to

    g = torch.Generator(device="cuda").manual_seed(6)
    nlist, lmax, nq, nprobe = 16, 300, 64, 5
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    n_rows = int(counts.sum()) + 500
    store = torch.randn(n_rows * d + shift, device="cuda", generator=g)
    lists = store[shift:].view(n_rows, d)
    half = n_rows // 2
    lists[half:2 * half] = lists[:half]
    offsets, row_pos = _unpadded(counts, n_rows, g)
    mask = (torch.rand(row_pos.shape[0], device="cuda", generator=g)
            < rate).to(torch.int8)
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    full = UnpaddedLayout(lists, counts, offsets, row_pos, xq[:0], lmax)
    idx = pass_index(full, mask)
    assert idx.row_pos.shape[0] == int((mask != 0).sum())
    for k in (10, k6.MAX_K + 1):
        want = pad_to(*k6.ivf_list_search(
            lists, counts, row_pos, probe, xq, mask, k=k, metric=metric,
            offsets=offsets, lmax=lmax), k)
        got = pad_to(*k6.ivf_list_search(
            lists, idx.counts, idx.row_pos, probe, xq, None, k=k,
            metric=metric, offsets=idx.offsets, lmax=idx.lmax), k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,d", [("sq8", 33), ("sq8", 1536), ("sq4", 128),
                                     ("sq6", 1536)])
def test_fused_sq_search_matches_plain_on_card(codec, d, metric):
    """The fused K2 on the card: its k_scan candidates bit-equal to the
    plain top-k_scan of the raw int8 scores, its results equal to the plain
    search's within 1e-5 of the batch's largest score and where apart;
    above its k_scan limit the raw launch serves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_code_width
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    g = torch.Generator(device="cuda").manual_seed(5)
    nlist, lmax, nq, nprobe, k, k_scan = 16, 256, 64, 5, 10, 42
    w = sq_code_width(d, codec)
    codes = torch.randint(0, 256, (nlist, lmax, w), device="cuda",
                          generator=g, dtype=torch.uint8)
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    rn = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    rs = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    vmin = torch.randn(d, device="cuda", generator=g)
    scale = torch.rand(d, device="cuda", generator=g) / 50 + 1e-3
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    args = (codes, rn, rs, counts, _live_row_pos(counts, lmax), probe, xq,
            mask, vmin, scale)
    kw = dict(k=k, k_scan=k_scan, metric=metric, codec=codec)
    launch = k2.TopKLaunch(*args, **kw)
    launch.run()
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    raw = k2.ivf_sq_scan_reference(codes, rn, rs, counts, probe, q.digits,
                                   q.scalars, mask, metric, codec)
    bs, sel = exact_topk(raw.reshape(nq, -1), k_scan)
    cs, cp = launch.candidates
    fin = torch.isfinite(bs)
    assert torch.equal(cs, bs) and torch.equal(cp[fin].long(), sel[fin])
    before = (k2.LAUNCHES, k2.TOPK_LAUNCHES)
    s, p = k2.ivf_sq_list_search(*args, **kw)
    torch.cuda.synchronize()
    rs_, rp = k2.ivf_sq_list_search_reference(*args, **kw)
    s, p, rs_, rp = (t.cpu().numpy() for t in (s, p, rs_, rp))
    finite = np.isfinite(rs_)
    np.testing.assert_array_equal(np.isfinite(s), finite)
    tol = 1e-5 * np.abs(rs_[finite]).max()
    assert (np.abs(np.where(finite, s - rs_, 0)) <= tol).all()
    gap = np.abs(np.diff(np.where(finite, rs_, -1e30), axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(p[sep], rp[sep])
    k2.ivf_sq_list_search(*args, k=k, k_scan=k2.MAX_K + 1, metric=metric,
                          codec=codec)
    assert (k2.LAUNCHES, k2.TOPK_LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.fixture
def card():
    """A CUDA device, decided here and not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def _pq_inputs(codec, m, nbits, d, nlist=16, lmax=256, nq=64, nprobe=3):
    """K8's arguments on the card, in ``ivf_pq_list_search``'s order: a
    padded code layout with an empty list, a full one and duplicated rows
    (slots 4 and 5 of every list), its row positions, codebooks,
    centroids, a probe table, queries and a mask; and the row terms."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    g = torch.Generator(device="cuda").manual_seed(3)
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    live = (torch.arange(lmax, device="cuda")[None, :]
            < counts[:, None]).to(torch.uint8)
    lists = torch.randint(0, 1 << nbits, (nlist, lmax, m), device="cuda",
                          generator=g, dtype=torch.uint8)
    lists[:, 5] = lists[:, 4]
    lists *= live[:, :, None]
    start = torch.cumsum(counts, 0) - counts
    row_pos = torch.where(live.bool(), start[:, None] + torch.arange(
        lmax, device="cuda")[None, :], -1).to(torch.int32)
    cb = torch.randn(m, 1 << nbits, d // m if codec == "pq" else d,
                     device="cuda", generator=g)
    cents = torch.randn(nlist, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    xq = torch.randn(nq, d, device="cuda", generator=g)
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    rt = k8.pq_row_terms(lists, counts, cents, cb, codec)
    return [lists, counts, row_pos, cb, cents, probe, xq, mask], rt


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,m,nbits,d", [("pq", 16, 8, 128),
                                             ("pq", 4, 4, 16),
                                             ("rq", 2, 4, 16),
                                             ("rq", 8, 8, 128)])
def test_pq_kernel_matches_plain_on_card(card, codec, m, nbits, d, metric,
                                         k):
    """K8 (the table, partial and merge launches of ivf_pq_list_search)
    against its plain torch version on the same card tensors: scores
    within 1e-5 of each query's scale (fp32 sums in another order),
    positions equal wherever the neighbouring scores are apart, tied rows
    to the lower storage row; one launch counted, no query unproven; the
    table launch against ``pq_lut_reference``."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    args, rt = _pq_inputs(codec, m, nbits, d)
    kw = dict(metric=metric, codec=codec, row_terms=rt)
    xq = args[6]
    before = k8.LAUNCHES
    k8.reset_unproven(card)
    s, p = k8.ivf_pq_list_search(*args, k=k, **kw)
    torch.cuda.synchronize()
    assert k8.LAUNCHES == before + 1 and k8.unproven(card) == 0
    rs, rp = k8.ivf_pq_list_search_reference(*args, k=k + 1, **kw)
    s, p, rs, rp = (t.cpu().numpy() for t in (s, p, rs, rp))
    finite = np.isfinite(rs)
    np.testing.assert_array_equal(np.isneginf(s), np.isneginf(rs[:, :k]))
    tol = 1e-5 * np.maximum(np.abs(np.where(finite, rs, 0)).max(1),
                            (xq * xq).sum(1).cpu().numpy())[:, None]
    diff = np.abs(np.where(finite[:, :k], s - rs[:, :k], 0))
    assert (diff <= tol).all(), diff.max()
    apart = np.abs(np.diff(np.where(finite, rs, -1e30), axis=1)) > 2 * tol
    sep = np.ones_like(s, bool)
    sep[:, 1:] &= apart[:, :k - 1]
    sep &= apart[:, :k]
    np.testing.assert_array_equal(p[sep], rp[:, :k][sep])
    np.testing.assert_array_equal(p[~finite[:, :k]], -1)
    tied = (s[:, 1:] == s[:, :-1]) & np.isfinite(s[:, 1:])
    assert (p[:, 1:][tied] > p[:, :-1][tied]).all()
    launch = k8.Launch(*args, k=k, **kw)
    launch.run(k8.TABLE)
    want = k8.pq_lut_reference(xq, args[3], codec)
    scale = (xq.abs().sum(1) * args[3].abs().max()).max()
    assert (launch.lut - want).abs().max() <= 1e-5 * scale
    assert k8.LAUNCHES == before + 1


@pytest.mark.gpu
def test_pq_kernel_raises_on_bad_inputs(card):
    """On CUDA tensors K8 launches or raises; it never falls back to the
    plain version."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    args, rt = _pq_inputs("pq", 4, 8, 16)
    kw = dict(k=10, metric="L2", codec="pq", row_terms=rt)
    before = k8.LAUNCHES
    k8.ivf_pq_list_search(*args, **kw)
    torch.cuda.synchronize()
    assert k8.LAUNCHES == before + 1
    lists, counts, row_pos, cb, cents, probe, xq, mask = args
    bad = {0: lists.to(torch.int32), 1: counts.to(torch.int64),
           2: row_pos[:, :8].contiguous(), 3: cb[:, :, :3].contiguous(),
           4: cents[:, :8].contiguous(), 5: probe[:, :1].t(), 6: xq.cpu(),
           7: mask[:4]}
    for i, value in bad.items():
        with pytest.raises(ValueError):
            k8.ivf_pq_list_search(*(args[:i] + [value] + args[i + 1:]),
                                  **kw)
    for change in ({"metric": "L1"}, {"codec": "opq"}, {"row_terms": None},
                   {"row_terms": rt[:4]}, {"k": 0}, {"k": k8.MAX_K + 1}):
        with pytest.raises(ValueError):
            k8.ivf_pq_list_search(*args, **{**kw, **change})
    assert k8.LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,d,lmax", [("sq8", 33, 256), ("sq8", 1536, 512),
                                          ("sq4", 128, 256), ("sq6", 33, 256),
                                          ("sq6", 1536, 256)])
def test_sq_mega_kernel_matches_plain_on_card(card, codec, d, lmax, metric):
    """K9 (pipelined SQ pair tiles) against its plain version and against
    K3 on the same card tensors, raw tiles bit for bit, with a mask, an
    empty list and a full one, and with n_tiles cut to 5 and to 0."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_code_width
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    g = torch.Generator(device="cuda").manual_seed(4)
    nlist, nq, nprobe = 16, 64, 3
    w = sq_code_width(d, codec)
    codes = torch.randint(0, 256, (nlist, lmax, w), device="cuda",
                          generator=g, dtype=torch.uint8)
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    rn = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    rs = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    vmin = torch.randn(d, device="cuda", generator=g)
    scale = torch.rand(d, device="cuda", generator=g) / 50 + 1e-3
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    dig_t, sc_t, meta, _ = k3.sq_pair_tile_inputs(probe, q, nlist, metric)
    args = [codes, rn, rs, counts, dig_t, sc_t, meta, mask, metric, codec]
    before = k9.LAUNCHES
    raw = k9.ivf_sq_pairs_mega_scan(*args)
    torch.cuda.synchronize()
    ref = k3.ivf_sq_pairs_scan_reference(*args)
    grid = k3.ivf_sq_pairs_scan(*args)
    n = int(meta[0])
    assert torch.equal(raw[:n], ref[:n]) and torch.equal(raw[:n], grid[:n])
    for cut in (5, 0):
        args[6] = meta.clone()
        args[6][0] = cut
        raw = k9.ivf_sq_pairs_mega_scan(*args)
        torch.cuda.synchronize()
        assert torch.equal(raw[:cut], ref[:cut])
    assert k9.LAUNCHES == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("lmax", [384, 640])
@pytest.mark.parametrize("codec", ["sq8", "sq4", "sq6"])
def test_sq_pair_kernels_bit_equal_at_d80_on_card(card, codec, lmax, metric):
    """K3 and K9 (its TMA producer at sq8, its cp.async instance at sq4 /
    sq6) bit-equal to their plain version and to each other at d = 80 (at
    sq8 whole 16-byte units but half a k-step), lists of count 0, 1 and
    lmax, lmax not a multiple of 256, with a mask."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_code_width
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    g = torch.Generator(device="cuda").manual_seed(7)
    d, nlist, nq, nprobe = 80, 16, 64, 3
    w = sq_code_width(d, codec)
    codes = torch.randint(0, 256, (nlist, lmax, w), device="cuda",
                          generator=g, dtype=torch.uint8)
    counts = torch.randint(2, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1], counts[2] = 0, 1, lmax
    rn = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    rs = torch.rand(nlist, lmax, device="cuda", generator=g) * 100
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    vmin = torch.randn(d, device="cuda", generator=g)
    scale = torch.rand(d, device="cuda", generator=g) / 50 + 1e-3
    xq = torch.randn(nq, d, device="cuda", generator=g)
    keys = torch.rand(nq, nlist, device="cuda", generator=g)
    keys[0, 0] = keys[1, 1] = keys[2, 2] = -1.0   # lists of count 0, 1, lmax
    probe = keys.argsort(1)[:, :nprobe].to(torch.int32).contiguous()
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    dig_t, sc_t, meta, _ = k3.sq_pair_tile_inputs(probe, q, nlist, metric)
    args = (codes, rn, rs, counts, dig_t, sc_t, meta, mask, metric, codec)
    before = (k3.LAUNCHES, k9.LAUNCHES)
    got = [k3.ivf_sq_pairs_scan(*args), k9.ivf_sq_pairs_mega_scan(*args)]
    torch.cuda.synchronize()
    assert (k3.LAUNCHES, k9.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert k9.last_plan[2] == (codec == "sq8")
    n = int(meta[0])
    ref = k3.ivf_sq_pairs_scan_reference(*args)
    for raw in got:
        assert torch.equal(raw[:n], ref[:n])


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("d,lmax", [(8, 256), (33, 256), (128, 512),
                                    (1536, 256)])
def test_flat_mega_kernel_matches_plain_on_card(card, d, lmax, metric):
    """K10 (pipelined Flat pair tiles) bit-equal to K7, and within 1e-5 of
    each row's scale of its plain version, on the same card tensors."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10

    g = torch.Generator(device="cuda").manual_seed(5)
    nlist, nq, nprobe = 16, 64, 3
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    lists = torch.randn(nlist, lmax, d, device="cuda", generator=g)
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq, nlist)
    args = (lists, counts, xq_t, qs_t, meta, mask, metric)
    before = k10.LAUNCHES
    raw = k10.ivf_pairs_mega_scan(*args)
    torch.cuda.synchronize()
    assert k10.LAUNCHES == before + 1
    n = int(meta[0])
    assert torch.equal(raw[:n], k7.ivf_pairs_scan(*args)[:n])
    ref = k7.ivf_pairs_scan_reference(*args)
    _rows_agree(raw[:n].reshape(-1, lmax), ref[:n].reshape(-1, lmax),
                qs_t[:n, :, 1].reshape(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("d,lmax,k,k_scan", [
    (8, 256, 1, 33), (33, 640, 10, 42), (128, 512, 100, 400),
    (1536, 256, 10, 42), (128, 1024, 256, 1024)])
def test_fused_pairs_search_matches_plain_on_card(card, d, lmax, k, k_scan,
                                                  metric):
    """The fused pair-tile search (K7's partial and merge, and K10's
    through TMA and through its cp.async instance) against its plain
    version on the same card tensors: scores within 1e-5 of the batch's
    largest, positions equal where neighbouring scores are further apart,
    equal rows (slots 4 and 5 of every list) in flat order; K10 bit-equal
    to K7; lists probed by more queries than an item holds and lists of
    several shares; above the k_scan limit the raw launches serve."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10

    g = torch.Generator(device="cuda").manual_seed(6)
    nlist, nq, nprobe = 16, 256, 3
    counts = torch.randint(1, lmax, (nlist,), device="cuda", generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    lists = torch.randn(nlist, lmax, d, device="cuda", generator=g)
    lists[:, 5] = lists[:, 4]
    mask = (torch.rand(nlist, lmax, device="cuda", generator=g)
            < 0.6).to(torch.int8)
    mask[:, 4:6] = 1
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    probe[2, 0] = 1
    probe[2, 1:] = torch.where(probe[2, 1:] == 1, 2, probe[2, 1:])
    xq[2] = lists[1, 4]
    row_pos = _live_row_pos(counts, lmax)
    kw = dict(k=k, k_scan=k_scan, metric=metric)
    for m in (None, mask):
        args = (lists, counts, row_pos, probe, xq, m)
        before = (k7.TOPK_LAUNCHES, k10.TOPK_LAUNCHES, k7.LAUNCHES,
                  k10.LAUNCHES)
        s, p = k7.ivf_pairs_search(*args, **kw)
        got = [(s, p), k7.ivf_pairs_search(*args, **kw, mega=True)]
        if k7.tma_ok(lists, xq):
            launch = k7.TopKLaunch(*args, **kw, mega=True, tma=False)
            launch.run()
            got.append((launch.scores, launch.positions))
        torch.cuda.synchronize()
        assert (k7.TOPK_LAUNCHES, k10.TOPK_LAUNCHES, k7.LAUNCHES,
                k10.LAUNCHES) == (before[0] + 1, before[1] + 1, before[2],
                                  before[3])
        for gs, gp in got[1:]:
            assert torch.equal(gs, s) and torch.equal(gp, p)
        rs, rp = k7.ivf_pairs_search_reference(*args, **kw)
        s, p, rs, rp = (t.cpu().numpy() for t in (s, p, rs, rp))
        finite = np.isfinite(rs)
        np.testing.assert_array_equal(np.isfinite(s), finite)
        tol = 1e-5 * np.abs(rs[finite]).max()
        assert (np.abs(np.where(finite, s - rs, 0)) <= tol).all()
        gap = np.abs(np.diff(np.where(finite, rs, -1e30), axis=1)) > 2 * tol
        sep = finite.copy()
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        np.testing.assert_array_equal(p[sep], rp[sep])
        if metric == "L2" and k > 1:
            assert p[2, :2].tolist() == row_pos[1, 4:6].tolist()
    if nprobe * lmax > k7.MAX_K_SCAN:
        before = (k7.LAUNCHES, k10.LAUNCHES)
        for mega in (False, True):
            k7.ivf_pairs_search(*args, k=k, k_scan=k7.MAX_K_SCAN + 1,
                                metric=metric, mega=mega)
        assert (k7.LAUNCHES, k10.LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec,d", [("sq8", 33), ("sq8", 1536), ("sq4", 128)])
def test_spill_rescore_matches_plain_on_card(card, codec, d, metric):
    """K5's rescore launch against ``spill_rescore_reference`` on the same
    card tensors: -inf in the same places, other scores within 1e-5 of the
    largest; then the whole spill search equal to its plain path's."""
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_code_width
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    g = torch.Generator(device="cuda").manual_seed(6)
    nlist, s_pad, n_rows, nq, nprobe = 16, 4096, 4000, 64, 4
    w = sq_code_width(d, codec)
    codes = torch.randint(0, 256, (s_pad, w), device="cuda", generator=g,
                          dtype=torch.uint8)
    assign = torch.randint(0, nlist, (s_pad,), device="cuda", generator=g,
                           dtype=torch.int32).sort().values
    offsets = torch.from_numpy(k5.spill_offsets(
        assign[:n_rows].cpu().numpy(), nlist)).cuda()
    pos = torch.where(torch.rand(s_pad, device="cuda", generator=g) < 0.9,
                      torch.arange(s_pad, device="cuda"), -1).to(torch.int32)
    rn = torch.rand(s_pad, device="cuda", generator=g) * 100
    rs = torch.rand(s_pad, device="cuda", generator=g) * 100
    mask = (torch.rand(s_pad, device="cuda", generator=g) < 0.7).to(
        torch.int8)
    vmin = torch.randn(d, device="cuda", generator=g)
    scale = torch.rand(d, device="cuda", generator=g) / 50 + 1e-3
    xq = torch.randn(nq, d, device="cuda", generator=g)
    probe = torch.rand(nq, nlist, device="cuda", generator=g).argsort(1)[
        :, :nprobe].to(torch.int32).contiguous()
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    wmax, warg = k5.sq_spill_windows_reference(
        codes, assign, pos, rs, rn, mask, probe, q.digits, q.scalars, n_rows,
        metric, codec)
    bestw, wsel = exact_topk(wmax, 32)
    args = (codes, assign, pos, mask, n_rows, probe, xq, vmin, scale, bestw,
            wsel, warg, 12, metric, codec)
    before = k5.RESCORE_LAUNCHES
    got = k5.spill_rescore(*args)
    torch.cuda.synchronize()
    assert k5.RESCORE_LAUNCHES == before + 1
    want = k5.spill_rescore_reference(*args)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert finite.any()
    tol = 1e-5 * float(want[finite].abs().max())
    assert float((got[finite] - want[finite]).abs().max()) <= tol
    search = dict(k=10, metric=metric, codec=codec)
    s_k, p_k = k5.sq_spill_search(codes, assign, pos, rs, rn, n_rows, probe,
                                  xq, mask, vmin, scale, offsets=offsets,
                                  **search)
    saved = k5.sq_spill_windows, k5.spill_rescore
    k5.sq_spill_windows = k5.sq_spill_windows_reference
    k5.spill_rescore = k5.spill_rescore_reference
    try:
        s_r, p_r = k5.sq_spill_search(codes, assign, pos, rs, rn, n_rows,
                                      probe, xq, mask, vmin, scale, **search)
    finally:
        k5.sq_spill_windows, k5.spill_rescore = saved
    assert torch.equal(torch.isneginf(s_k), torch.isneginf(s_r))
    np.testing.assert_allclose(s_k.cpu().numpy(), s_r.cpu().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
def test_flat_kernel_proves_its_margin_on_card(card, metric):
    """K1's partial and merge launches on a clustered corpus: the result
    equals the plain version's and no query's (k + m)-th 3xTF32 candidate
    comes within twice the error bound of its k-th exact score."""
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((64, 128)).astype(np.float32) * 4
    xb = torch.from_numpy(centers[rng.integers(0, 64, 20000)]
                          + rng.standard_normal((20000, 128))
                          .astype(np.float32)).cuda()
    xq = torch.from_numpy(centers[rng.integers(0, 64, 64)]
                          + rng.standard_normal((64, 128))
                          .astype(np.float32)).cuda()
    ft.reset_unproven("cuda")
    before = ft.LAUNCHES
    s, p = ft.flat_topk(xb, 20000, xq, 10, metric)
    torch.cuda.synchronize()
    assert ft.LAUNCHES == before + 1 and ft.unproven("cuda") == 0
    rs, rp = ft.flat_topk_reference(xb, 20000, xq, 10, metric)
    np.testing.assert_array_equal(p.cpu().numpy(), rp.cpu().numpy())
    tol = 1e-5 * float(rs.abs().max())
    np.testing.assert_allclose(s.cpu().numpy(), rs.cpu().numpy(), rtol=0,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,nq,tie", [("L2", 64, False),
                                           ("L2", 1024, False),
                                           ("INNER_PRODUCT", 64, False),
                                           ("L2", 64, True)])
def test_coarse_stage_takes_k1_on_card(card, metric, nq, tie):
    """The IVF coarse stage at the benchmark's shape (4096 x 128 centroids
    of a clustered stand-in, nprobe 64) through K1's dense regime: one
    launch, one ``models.coarse_kernel`` and one ``kernels.flat_topk_dense``
    count a call, no margin-unproven query, the
    probes equal to the plain chain's or both within the rounding bound;
    a duplicated centroid resolves to the lower list id."""
    from chip_smoke import probes_allowed
    from duckdb_faiss_ext_tpu_torch.ops import ivf_scan
    g = torch.Generator(device=card).manual_seed(20)
    centres = torch.randn(1024, 128, device=card, generator=g) * 4
    cents = (centres.repeat(4, 1)
             + 0.5 * torch.randn(4096, 128, device=card, generator=g))
    xq = (centres[torch.randint(0, 1024, (nq,), device=card, generator=g)]
          + torch.randn(nq, 128, device=card, generator=g))
    if tie:
        cents[3000] = cents[17]
        xq[0] = cents[17]
    def launched():
        counters = dt.faiss_stats()["counters"]
        return (ft.LAUNCHES, counters["models.coarse_kernel"],
                counters[ft.DENSE_CALLS])

    ft.reset_unproven(card)
    before = launched()
    ids = ivf_scan.coarse_topk(xq, cents, 64, metric)
    torch.cuda.synchronize()
    assert launched() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert ft.unproven(card) == 0
    plain = ivf_scan.coarse_topk_plain(xq, cents, 64, metric)
    assert ids.dtype == torch.int32 and ids.shape == (nq, 64)
    differ = (ids != plain).any(1)
    assert probes_allowed(ids, xq, cents, metric)[differ].all()
    assert probes_allowed(plain, xq, cents, metric)[differ].all()
    if tie:
        assert ids[0, :2].tolist() == [17, 3000]


def _k1_inputs(card, seed, nq, cap, d, dup):
    g = torch.Generator(device=card).manual_seed(seed)
    xb = torch.randn(cap, d, device=card, generator=g)
    xq = torch.randn(nq, d, device=card, generator=g)
    if dup:
        rows = [5, 17, 40, 41, cap // 2]
        xb[rows] = xb[rows[0]].clone()
        xq[0] = xb[rows[0]]
    return xb, xq


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("nq,cap,nvalid,d,k,masked,dup", [
    (64, 2048, 2048, 1536, 15, False, False),      # the marco coarse stage
    (64, 4096, 4096, 128, 64, False, False),       # IVF4096 at b48
    (1024, 4096, 4096, 128, 64, False, False),     # IVF4096 at b1024
    (1, 3001, 3001, 128, 10, False, True),         # one query, a ragged tile
    (1023, 3001, 2999, 96, 10, True, False),       # nvalid < cap, a mask
    (7, 300, 300, 32, 300, False, True),           # k = n_scan
    (5, 50, 47, 30, 40, True, False),              # 4-byte copies; < k + m rows
    (64, 20000, 19000, 128, 10, True, True),
    (2048, 2048, 2048, 128, 129, False, True)])     # a kNN-graph build
def test_k1_regimes_equal_on_card(card, metric, nq, cap, nvalid, d, k,
                                  masked, dup):
    """The dense regime against the split regime, each forced through
    ``chip_smoke.k1_plan``: (scores, positions) equal bit for bit and the
    same unproven count; both against the plain version (scores within
    1e-5 of the largest, positions equal where neighbours, the k-th's
    first neighbour past k too, are further apart); rows duplicated to tie
    rank by position."""
    from chip_smoke import k1_plan
    xb, xq = _k1_inputs(card, 24, nq, cap, d, dup)
    mask = None
    if masked:
        g = torch.Generator(device=card).manual_seed(25)
        mask = torch.rand(cap, device=card, generator=g) < 0.5
        if dup:
            mask[[5, 17, 40, 41, cap // 2]] = True
    got = {}
    for regime in ("split", "dense"):
        with k1_plan(regime):
            ft.reset_unproven(card)
            s, p = ft.flat_topk(xb, nvalid, xq, k, metric, mask)
            got[regime] = (s.cpu(), p.cpu(), ft.unproven(card))
    (ss, sp, su), (ds, dp, du) = got["split"], got["dense"]
    assert torch.equal(sp, dp) and su == du
    assert torch.equal(ss.view(torch.int32), ds.view(torch.int32))
    # one reference slot past k, so the k-th is judged against the next
    rs, rp = ft.flat_topk_reference(xb, nvalid, xq, min(k + 1, nvalid),
                                    metric, mask)
    s, p, rs, rp = ds.numpy(), dp.numpy(), rs.cpu().numpy(), rp.cpu().numpy()
    finite = np.isfinite(rs)
    tol = 1e-5 * np.abs(rs[:, :k][finite[:, :k]]).max()
    gap = np.diff(np.where(finite, rs, -1e30), axis=1)
    separated = finite.copy()
    separated[:, 1:] &= np.abs(gap) > 2 * tol
    separated[:, :-1] &= np.abs(gap) > 2 * tol
    finite, separated, rs, rp = (a[:, :k] for a in (finite, separated, rs,
                                                    rp))
    np.testing.assert_array_equal(np.isfinite(s), finite)
    np.testing.assert_allclose(s[finite], rs[finite], rtol=0, atol=tol)
    np.testing.assert_array_equal(p[~finite], -1)
    np.testing.assert_array_equal(
        p[separated], rp[separated],
        err_msg=f"columns {np.nonzero((p != rp) & separated)[1]}")
    if dup and k >= 5:
        np.testing.assert_array_equal(p[0, :5], [5, 17, 40, 41, cap // 2])


@pytest.mark.gpu
def test_dense_regime_counted_on_card(card):
    """``kernels.flat_topk_dense`` counts one a K1 call the dense regime
    served (the plan's choice at the marco coarse shape) and none on the
    split path (1024 queries over 20,000 rows: the score tile, 4 x 1024 x
    20,000 bytes, is over ``DENSE_SCRATCH``)."""
    for nq, rows, d, dense in ((64, 2048, 1536, True),
                               (1024, 20000, 128, False)):
        assert (ft.plan(nq, d, 15, rows, 132)["dense"] is not None) is dense
        xb, xq = _k1_inputs(card, 26, nq, rows, d, False)
        before = (ft.LAUNCHES, dt.faiss_stats()["counters"][ft.DENSE_CALLS])
        ft.flat_topk(xb, rows, xq, 15, "INNER_PRODUCT")
        torch.cuda.synchronize()
        after = (ft.LAUNCHES, dt.faiss_stats()["counters"][ft.DENSE_CALLS])
        assert after == (before[0] + 1, before[1] + int(dense))


def _clustered_rows(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, 24, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.4)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["sq8", "sq4", "sq6"])
def test_int8_scan_on_card_matches_cpu(card, codec, metric):
    """The int8 scan on card tensors (``torch._int_mm``'s shape rules met by
    padding: 8 queries, odd d, a capacity tail) against the same scan on
    CPU tensors: integer dots exact on both, so labels equal where the
    distances are apart."""
    n, d, nq = 5000, 45, 8
    xb = torch.from_numpy(_clustered_rows(23, n, d))
    xq = torch.from_numpy(_clustered_rows(24, nq, d))
    vmin, scale = psq.sq_train(xb, psq.SQ_LEVELS[codec])
    q = psq.sq_quantize(xb, vmin, scale, psq.SQ_LEVELS[codec]).numpy()
    codes = psq.sq_pack(q, codec)
    cap = 8192
    pad = np.zeros((cap - n, codes.shape[1]), np.uint8)
    codes = torch.from_numpy(np.concatenate([codes, pad]))
    rn = torch.from_numpy(np.concatenate([psq.sq_row_norms(
        codes.numpy()[:n], scale.numpy(), d, codec), np.zeros(cap - n,
                                                             np.float32)]))
    rs = torch.from_numpy(np.concatenate([psq.sq_row_sums(
        codes.numpy()[:n], d, codec), np.zeros(cap - n, np.float32)]))
    kw = dict(k=10, k_scan=42, metric=metric, codec=codec)
    args = (codes, rn, rs, n, vmin, scale, xq, None)
    s_cpu, p_cpu = psq.sq_int8_search(*args, **kw)
    s_gpu, p_gpu = psq.sq_int8_search(
        *(a.to(card) if torch.is_tensor(a) else a for a in args), **kw)
    s_gpu, p_gpu = s_gpu.cpu(), p_gpu.cpu()
    tol = 1e-5 * max(float(s_cpu.abs().max()), float((xq * xq).sum(1).max()))
    np.testing.assert_allclose(s_gpu.numpy(), s_cpu.numpy(), rtol=0,
                               atol=tol)
    gap = (s_cpu[:, :-1] - s_cpu[:, 1:]).abs() > 2 * tol
    sep = torch.ones_like(p_cpu, dtype=torch.bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert torch.equal(p_gpu[sep], p_cpu[sep])
    a = torch.randint(-127, 128, (3, d), dtype=torch.int8)
    got = psq.int8_dots(a.to(card), codes[:40].to(card), d, codec).cpu()
    assert torch.equal(got, psq.int8_dots(a, codes[:40], d, codec))
