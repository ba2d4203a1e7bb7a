"""IVF,SQ8/SQ4 spill search (K5): the hand-written CUDA kernels
``csrc/sq_spill.cu``, their wrappers, their plain torch versions, and the
search around them.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_spill.py::
_spill_kernel`` and the rerank legs of its wrapper ``pallas_spill_search``.
The spill region holds the rows of lists longer than the capped padded
layout (models/ivf_layout.py), sorted by list: (s_pad, w) packed codes with
each row's list (``assign``), storage row (``pos``, -1 padding),
Σ(scale·c)², Σc, and ``offsets`` (nlist + 1,): list l's rows are
[offsets[l], offsets[l + 1]).

Two kernels:

* the windows (``sq_spill_windows``): every row scored against every query
  whose probes hold the row's list (int8 digits, ops/sq_digits.py; -inf
  otherwise), each 128-row window reduced to its max score and the first
  row reaching it: (nq, nwin) fp32 + int32.  The kernel walks each (query,
  probe)'s spill range only, so it reads the probed lists' rows and no
  other;
* the rescore (``spill_rescore``): the rows of each query's top k + 2
  windows (the candidate-lossless leg: a row of an unselected window scores
  at most its window's max, below k selected windows' rows, in the int8
  order) and the argmax rows of the windows ranked k + 3 … k_scan, each
  decoded and scored in fp32 where it is valid for the query.

Between and after them, as outside the ``pallas_call``
(``sq_spill_search``): the top ``k_scan`` windows per query, then the best k
of the rescored rows, padded back to the caller's k when the spill has
fewer windows.

What bounds it on the H100: device memory, the probed lists' spill codes
for the windows and the selected rows' codes for the rescore (details in
the CUDA source).

``sq_spill_windows`` and ``spill_rescore`` launch their kernels for CUDA
tensors and raise on what the kernels do not take; they take their plain
versions only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .flat_search import exact_topk
from .ivf_list_scan import expect
from .ivf_sq_scan import check_digits, vec_ok
from .sq import sq_decode
from .sq_digits import (CODEC_ID, KERNEL_SHIFT, METRICS, int8_scores,
                        query_digits, unpack_f64)
from ..utils.config import full_fp32
from ..utils.profiling import spanned

#: launches of the window kernel, and of the rescore kernel, since import
#: (or since a caller reset them)
LAUNCHES = 0
RESCORE_LAUNCHES = 0

#: rows per window
WIN = 128

#: codecs the kernel takes (sq6 spills take the plain int8 spill scan)
CODECS = ("sq8", "sq4")

_NEG_INF = float("-inf")


def probed(probe_ids: torch.Tensor, lists: torch.Tensor) -> torch.Tensor:
    """(nq, r) bool: whether list ``lists[q, j]`` is among query q's
    probes."""
    probes, _ = probe_ids.long().sort(1)
    lists = lists.long().contiguous()
    idx = torch.searchsorted(probes, lists).clamp(max=probes.shape[1] - 1)
    return probes.gather(1, idx) == lists


def spill_offsets(assign: np.ndarray, nlist: int) -> np.ndarray:
    """(nlist + 1,) int64: the first spill row of each list, then the
    row count, over ``assign`` (the real spill rows' lists), which must be
    sorted by list."""
    assign = np.asarray(assign)
    if not (np.diff(assign) >= 0).all():
        raise ValueError("spill rows are not sorted by list")
    return np.searchsorted(assign, np.arange(nlist + 1)).astype(np.int64)


def sq_spill_windows_reference(codes, assign, pos, rs, rn, mask, probe_ids,
                               digits, scalars, n_rows, metric, codec,
                               offsets=None):
    """Plain torch version: per chunk of whole windows, the exact float64
    digit dots of every query against every row, the fp32 epilogue, the
    probe / pos / mask validity, then each window's max and first argmax.
    Returns (wmax (nq, nwin) fp32, warg (nq, nwin) int32).  ``offsets`` is
    the kernel's; this version reads each row's list from ``assign``."""
    nq = probe_ids.shape[0]
    width = digits.shape[-1]
    nwin = -(-n_rows // WIN)
    dev = codes.device
    wmax = torch.empty((nq, nwin), dtype=torch.float32, device=dev)
    warg = torch.empty((nq, nwin), dtype=torch.int32, device=dev)
    rc = max(WIN, (1 << 25) // max(width, 2 * nq, 1) // WIN * WIN)
    dig2 = digits.reshape(2 * nq, width).to(torch.float64)
    for r0 in range(0, nwin * WIN, rc):
        r1 = min(r0 + rc, n_rows)
        c = unpack_f64(codes[r0:r1], codec, KERNEL_SHIFT[codec], width)
        dots = (dig2 @ c.T).reshape(nq, 2, r1 - r0)
        s = int8_scores(dots[:, 0], dots[:, 1], scalars[:, None, :],
                        rs[None, r0:r1], rn[None, r0:r1], metric)
        lists = assign[None, r0:r1].expand(nq, -1)
        valid = probed(probe_ids, lists) & (pos[None, r0:r1] >= 0)
        if mask is not None:
            valid = valid & (mask[None, r0:r1] != 0)
        s = torch.where(valid, s, _NEG_INF)
        nw = -(-(r1 - r0) // WIN)
        s = F.pad(s, (0, nw * WIN - (r1 - r0)), value=_NEG_INF)
        best, arg = s.reshape(nq, nw, WIN).max(2)      # first max on ties
        w0 = r0 // WIN
        wmax[:, w0:w0 + nw] = best
        warg[:, w0:w0 + nw] = (r0 + torch.arange(nw, device=dev)[None, :]
                               * WIN + arg).to(torch.int32)
    return wmax, warg


@spanned("kernels.sq_spill")
def sq_spill_windows(codes: torch.Tensor, assign: torch.Tensor,
                     pos: torch.Tensor, rs: torch.Tensor, rn: torch.Tensor,
                     mask: torch.Tensor | None, probe_ids: torch.Tensor,
                     digits: torch.Tensor, scalars: torch.Tensor,
                     n_rows: int, metric: str, codec: str,
                     offsets: torch.Tensor | None = None):
    """(wmax, warg) (nq, ceil(n_rows / WIN)) of the first ``n_rows`` spill
    rows (see the module docstring); ``digits`` / ``scalars`` come from
    ``sq_digits.query_digits`` with the codec's KERNEL_SHIFT.  The kernel
    needs ``offsets`` (``spill_offsets``) of a spill sorted by list."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (codes, assign, pos, rs, rn,
                                             probe_ids, digits, scalars)):
        return sq_spill_windows_reference(codes, assign, pos, rs, rn, mask,
                                          probe_ids, digits, scalars, n_rows,
                                          metric, codec, offsets)
    fn = "sq_spill_windows"
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    if codec not in CODECS or metric not in METRICS:
        raise ValueError(f"{fn}: unsupported codec {codec} or metric "
                         f"{metric}")
    expect(fn, "codes", codes, (torch.uint8,), (None, None), dev)
    s_pad, w = codes.shape
    expect(fn, "assign", assign, (torch.int32,), (s_pad,), dev)
    expect(fn, "pos", pos, (torch.int32,), (s_pad,), dev)
    for name, t in (("rs", rs), ("rn", rn)):
        expect(fn, name, t, (torch.float32,), (s_pad,), dev)
    if mask is not None:
        expect(fn, "mask", mask, (torch.int8, torch.uint8, torch.bool),
               (s_pad,), dev)
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, nprobe = probe_ids.shape
    check_digits(fn, digits, scalars, nq, w, codec, dev)
    if not 0 <= n_rows <= s_pad:
        raise ValueError(f"{fn}: n_rows {n_rows} outside the {s_pad} rows")
    if offsets is None:
        raise ValueError(f"{fn}: the kernel needs the spill's list offsets")
    expect(fn, "offsets", offsets, (torch.int64,), (None,), dev)
    nwin = -(-n_rows // WIN)
    if nq * nprobe >= 2 ** 31:
        raise ValueError(f"{fn}: {nq} queries x {nprobe} probes exceed the "
                         f"grid")
    from ..utils.kernels import load_library

    lib = load_library()
    wmax = torch.empty((nq, nwin), dtype=torch.float32, device=dev)
    warg = torch.empty((nq, nwin), dtype=torch.int32, device=dev)
    if nq * nwin * nprobe == 0:
        return wmax.fill_(_NEG_INF), warg.copy_(
            torch.arange(nwin, dtype=torch.int32, device=dev) * WIN)
    # (query, probe) slots in list order: the queries of a list side by side.
    units = probe_ids.reshape(-1).argsort().to(torch.int32)
    keys = torch.zeros((nq, nwin), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.dfx_sq_spill_windows(
            codes.data_ptr(), pos.data_ptr(), rs.data_ptr(), rn.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            offsets.data_ptr(), probe_ids.data_ptr(), units.data_ptr(),
            digits.data_ptr(), scalars.data_ptr(), nq, nprobe, n_rows, w,
            CODEC_ID[codec], int(metric == "L2"), int(vec_ok(codes, codec)),
            keys.data_ptr(), wmax.data_ptr(), warg.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sq_spill_windows: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return wmax, warg


def spill_rerank_scores(xs: torch.Tensor, xq: torch.Tensor,
                        metric: str) -> torch.Tensor:
    """fp32 scores of each query against its own decoded rows (qb, c, d),
    in the JAX spill scans' expansion form: x·q at full fp32, L2
    −max(‖q‖² − 2x·q + ‖x‖², 0)."""
    with full_fp32():
        xy = torch.bmm(xs, xq[:, :, None])[:, :, 0]
    if metric == "INNER_PRODUCT":
        return xy
    qn = (xq * xq).sum(1, keepdim=True)
    bn = (xs * xs).sum(2)
    return -(qn - 2.0 * xy + bn).clamp(min=0.0)


def spill_rescore_reference(codes, assign, pos, mask, n_rows, probe_ids, xq,
                            vmin, scale, bestw, wsel, warg, kw, metric,
                            codec):
    """Plain torch version of the rescore: (nq, kw·WIN + nt) fp32 scores,
    nt = k_scan − kw, of every row of each query's top ``kw`` windows
    (``wsel[:, :kw]``), then of the argmax rows of its windows ranked
    kw+1 … k_scan (``bestw`` their maxima); -inf where a row is not valid
    for the query (past ``n_rows``, pos < 0, masked, list not probed) and
    where a window's max is -inf."""
    nq, d = xq.shape
    s_pad = codes.shape[0]
    dev = xq.device
    k_scan = wsel.shape[1]
    parts_s = []

    # The candidate-lossless leg: every row of each query's top kw windows,
    # in query blocks that keep the decoded tile near 2^26 values.
    lane = torch.arange(WIN, device=dev)
    rows_full = (wsel[:, :kw, None].long() * WIN + lane).reshape(nq, kw * WIN)
    s_full = torch.empty((nq, kw * WIN), dtype=torch.float32, device=dev)
    qb = max(1, (1 << 26) // max(kw * WIN * d, 1))
    for q0 in range(0, nq, qb):
        rows = rows_full[q0:q0 + qb]
        safe = rows.clamp(max=s_pad - 1)
        n = rows.shape[0]
        xs = sq_decode(codes[safe.reshape(-1)], vmin, scale, codec) \
            .reshape(n, kw * WIN, d)
        ok = (probed(probe_ids[q0:q0 + qb], assign[safe])
              & (rows < n_rows) & (pos[safe] >= 0))
        if mask is not None:
            ok = ok & (mask[safe] != 0)
        s_full[q0:q0 + qb] = torch.where(
            ok, spill_rerank_scores(xs, xq[q0:q0 + qb], metric), _NEG_INF)
    parts_s.append(s_full)

    # The window-argmax leg: windows ranked kw+1 … k_scan (disjoint from
    # the first leg's windows).
    nt = k_scan - kw
    if nt:
        cand = warg.gather(1, wsel[:, kw:]).long()
        xs = sq_decode(codes[cand.reshape(-1)], vmin, scale, codec) \
            .reshape(nq, nt, d)
        parts_s.append(torch.where(torch.isneginf(bestw[:, kw:]), _NEG_INF,
                                   spill_rerank_scores(xs, xq, metric)))
    return torch.cat(parts_s, 1)


@spanned("kernels.sq_spill")
def spill_rescore(codes, assign, pos, mask, n_rows, probe_ids, xq, vmin,
                  scale, bestw, wsel, warg, kw, metric, codec):
    """``spill_rescore_reference``'s contract; the kernel tests each row's
    validity itself, which gives -inf exactly where the plain version's
    window maxima do."""
    global RESCORE_LAUNCHES
    if all(t.device.type == "cpu" for t in (codes, assign, pos, probe_ids,
                                             xq, vmin, scale, wsel, warg)):
        return spill_rescore_reference(codes, assign, pos, mask, n_rows,
                                       probe_ids, xq, vmin, scale, bestw,
                                       wsel, warg, kw, metric, codec)
    fn = "spill_rescore"
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    if codec not in CODECS or metric not in METRICS:
        raise ValueError(f"{fn}: unsupported codec {codec} or metric "
                         f"{metric}")
    expect(fn, "codes", codes, (torch.uint8,), (None, None), dev)
    s_pad, w = codes.shape
    expect(fn, "assign", assign, (torch.int32,), (s_pad,), dev)
    expect(fn, "pos", pos, (torch.int32,), (s_pad,), dev)
    if mask is not None:
        expect(fn, "mask", mask, (torch.int8, torch.uint8, torch.bool),
               (s_pad,), dev)
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, nprobe = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, None), dev)
    d = xq.shape[1]
    for name, t in (("vmin", vmin), ("scale", scale)):
        expect(fn, name, t, (torch.float32,), (d,), dev)
    expect(fn, "warg", warg, (torch.int32,), (nq, None), dev)
    expect(fn, "wsel", wsel, (torch.int64,), (nq, None), dev)
    nwin, k_scan = warg.shape[1], wsel.shape[1]
    if not 0 <= kw <= k_scan <= nwin or not 0 <= n_rows <= s_pad \
            or nq >= 2 ** 31:
        raise ValueError(f"{fn}: kw {kw}, k_scan {k_scan}, {nwin} windows "
                         f"and n_rows {n_rows} do not fit {s_pad} rows")
    out = torch.empty((nq, kw * WIN + k_scan - kw), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    from ..utils.kernels import load_library

    lib = load_library()
    words = w % 4 == 0 and codes.data_ptr() % 4 == 0
    with torch.cuda.device(dev):
        err = lib.dfx_sq_spill_rescore(
            codes.data_ptr(), assign.data_ptr(), pos.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            probe_ids.data_ptr(), xq.data_ptr(), vmin.data_ptr(),
            scale.data_ptr(), wsel.data_ptr(), warg.data_ptr(), nq, nprobe,
            n_rows, nwin, k_scan, kw, d, w, CODEC_ID[codec],
            int(metric == "L2"), int(words), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
    RESCORE_LAUNCHES += 1
    return out


def sq_spill_search(codes, assign, pos, rs, rn, n_rows, probe_ids, xq, mask,
                    vmin, scale, *, k, metric, codec, offsets=None):
    """``pallas_spill_search``'s contract: (scores (nq, k) max-oriented
    fp32-exact, storage positions (nq, k) int32, -1 missing) over the
    first ``n_rows`` spill rows; on the card ``offsets`` (the spill's
    ``spill_offsets``) is required."""
    nq, d = xq.shape
    s_pad, w = codes.shape
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    wmax, warg = sq_spill_windows(codes, assign, pos, rs, rn, mask, probe_ids,
                                  q.digits, q.scalars, n_rows, metric, codec,
                                  offsets)
    nwin = wmax.shape[1]
    if nwin == 0 or k <= 0:
        return (torch.full((nq, k), _NEG_INF, device=xq.device),
                torch.full((nq, k), -1, dtype=torch.int32, device=xq.device))
    k_req = k
    k = min(k, nwin)            # a small spill can have fewer windows than k
    f, add = (8, 96) if codec == "sq4" else (4, 32)
    k_scan = min(nwin, max(f * k, k + add))
    bestw, wsel = exact_topk(wmax, k_scan)
    kw = min(nwin, k + 2)
    s2 = spill_rescore(codes, assign, pos, mask, n_rows, probe_ids, xq, vmin,
                       scale, bestw, wsel, warg, kw, metric, codec)
    lane = torch.arange(WIN, device=xq.device)
    cand = torch.cat([(wsel[:, :kw, None] * WIN + lane).reshape(nq, kw * WIN),
                      warg.gather(1, wsel[:, kw:]).long()], 1)
    best, sel2 = exact_topk(s2, k)
    rows = cand.gather(1, sel2)
    out_pos = pos[rows.clamp(max=s_pad - 1)]
    out_pos = torch.where(torch.isneginf(best), -1, out_pos)
    if k < k_req:                 # pad back to the caller's k
        best = F.pad(best, (0, k_req - k), value=_NEG_INF)
        out_pos = F.pad(out_pos, (0, k_req - k), value=-1)
    return best, out_pos
