"""Pair-tile IVF,Flat scan (K7): the hand-written CUDA kernel
``csrc/ivf_pairs.cu``, its wrapper, its plain torch version, and the
tile table and epilogue around it.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
_pairs_flat_kernel`` (wrapper ``pallas_ivf_pairs_search``).  Each query
probes different lists, so a batch cannot share list reads per query; it
can per list.  The (nq, nprobe) probe map is inverted into tiles of one
list and ``QG`` = 8 queries (``build_pair_tiles``); the kernel scores each
tile's queries against its list block in one pass, writing raw (t_max, qg,
lmax) scores:

* inner product ``x·q + bias``; L2 ``-max(‖q‖² − 2x·q + ‖x‖², 0) + bias``
  (expansion form, as the TPU kernel computes it), with ``bias`` -inf on
  the tile's empty query slots and ``‖q‖²`` from the ``qs`` table;
* -inf at or beyond the list's count or where the mask byte is 0;
* tiles at or beyond ``n_tiles`` (read from ``meta[0]`` on the device) are
  left unwritten: no ``pair_slot`` points into them.

Outside the kernel, as outside the ``pallas_call`` in the JAX package, the
epilogue (``pairs_flat_epilogue``) gathers each pair's row back, selects
``k_scan`` candidates per query, re-scores them in fp32 difference form
and keeps the best k.

What bounds it on the H100: fp32 FMAs (8 x lmax x d per tile) and reading
each list block once per tile (the TPU version's point: a list row serves
8 queries per read).  The design (details in the CUDA source): one block
per tile streams the list block through shared memory in 256-row x 32-dim
chunks, each thread owning one row and the 8 queries' dot products.

``ivf_pairs_scan`` launches the kernel for CUDA tensors and raises on what
the kernel does not take; it takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from .flat_search import exact_topk
from .ivf_list_scan import check_lists, expect

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

#: queries per tile (the TPU version's MXU sublane batch; here the number
#: of dot products each thread keeps in registers)
QG = 8

#: t_max is rounded up to a multiple of this, as the JAX package rounds it
#: to its tiles per grid step (at most 4)
TILE_ROUND = 4

_NEG_INF = float("-inf")


def pairs_t_max(nq: int, nprobe: int, nlist: int, qg: int = QG) -> int:
    """Static worst-case tile count: every list's pairs fill
    ``floor(npair/qg)`` whole tiles at most, plus at most one partial
    tile per active list."""
    npair = nq * nprobe
    return npair // qg + min(nlist, npair)


def build_pair_tiles(probe_ids: torch.Tensor, *, nlist: int, t_max: int,
                     qg: int = QG):
    """Invert (nq, nprobe) probe ids into per-list query tiles.

    Returns (tile_list (t_max,) int32 list id per tile, 0 for padding;
    tile_q (t_max, qg) int32 query ids, -1 for empty slots; pair_slot
    (nq, nprobe) int32 flat (tile*qg + slot) index of each pair; n_tiles
    0-d int32 count of real tiles), all on the probe ids' device with no
    host round trip."""
    nq, nprobe = probe_ids.shape
    npair = nq * nprobe
    dev = probe_ids.device
    lists = probe_ids.reshape(-1).long()
    qid = torch.arange(npair, device=dev) // nprobe
    order = torch.argsort(lists, stable=True)
    sl = lists[order]
    sq = qid[order]
    m = torch.bincount(lists, minlength=nlist)
    tiles_pl = (m + qg - 1) // qg
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    start_tile = torch.cat([zero, torch.cumsum(tiles_pl, 0)[:-1]])
    first_idx = torch.cat([zero, torch.cumsum(m, 0)[:-1]])
    r = torch.arange(npair, device=dev) - first_idx[sl]
    tile = start_tile[sl] + r // qg
    slot = r % qg
    tile_q = torch.full((t_max, qg), -1, dtype=torch.int32, device=dev)
    tile_q[tile, slot] = sq.to(torch.int32)
    tile_list = torch.zeros(t_max, dtype=torch.int32, device=dev)
    tile_list[tile] = sl.to(torch.int32)
    pair_slot = torch.zeros(npair, dtype=torch.int32, device=dev)
    pair_slot[order] = (tile * qg + slot).to(torch.int32)
    return (tile_list, tile_q, pair_slot.reshape(nq, nprobe),
            tiles_pl.sum().to(torch.int32))


def ivf_pairs_scan_reference(lists, counts, xq_t, qs_t, meta, mask, metric):
    """Plain torch version: a batched fp32 product of the tiles' queries
    (t, qg, d) by their list blocks (t, lmax, d), chunked over tiles.
    Writes every tile; the kernel leaves those at or beyond ``meta[0]``
    unwritten."""
    t_max, qg, d = xq_t.shape
    lmax = lists.shape[1]
    out = torch.empty((t_max, qg, lmax), dtype=torch.float32,
                      device=lists.device)
    tile_list = meta[1:].long()
    lane = torch.arange(lmax, device=lists.device)
    tc = max(1, (1 << 26) // max(lmax * d, 1))
    for t0 in range(0, t_max, tc):
        lids = tile_list[t0:t0 + tc]
        block = lists[lids]                                 # (t, lmax, d)
        q = xq_t[t0:t0 + tc]
        xy = torch.bmm(q, block.transpose(1, 2))            # (t, qg, lmax)
        bias = qs_t[t0:t0 + tc, :, 0:1]
        if metric == "INNER_PRODUCT":
            s = xy + bias
        else:
            qn = qs_t[t0:t0 + tc, :, 1:2]
            bn = (block * block).sum(-1)[:, None, :]
            s = -(qn - 2.0 * xy + bn).clamp(min=0.0) + bias
        valid = lane < counts[lids][:, None]
        if mask is not None:
            valid = valid & (mask[lids] != 0)
        out[t0:t0 + tc] = torch.where(valid[:, None, :], s, _NEG_INF)
    return out


def ivf_pairs_scan(lists: torch.Tensor, counts: torch.Tensor,
                   xq_t: torch.Tensor, qs_t: torch.Tensor, meta: torch.Tensor,
                   mask: torch.Tensor | None, metric: str) -> torch.Tensor:
    """Raw (t_max, qg, lmax) float32 tile scores (see the module
    docstring).  xq_t (t_max, qg, d) and qs_t (t_max, qg, 4) float32 hold
    each tile's queries and (bias, ‖q‖², 0, 0); meta (1 + t_max,) int32 is
    n_tiles followed by the tiles' list ids."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (lists, counts, xq_t, qs_t, meta)):
        return ivf_pairs_scan_reference(lists, counts, xq_t, qs_t, meta, mask,
                                        metric)
    check_pairs("ivf_pairs_scan", lists, counts, xq_t, qs_t, meta, mask,
                metric)
    from ..utils.kernels import load_library

    lib = load_library()
    nlist, lmax, d = lists.shape
    t_max = xq_t.shape[0]
    out = torch.empty((t_max, QG, lmax), dtype=torch.float32,
                      device=lists.device)
    if t_max == 0:
        return out
    vec4 = d % 4 == 0 and lists.data_ptr() % 16 == 0
    with torch.cuda.device(lists.device):
        err = lib.dfx_ivf_pairs(
            lists.data_ptr(), counts.data_ptr(), xq_t.data_ptr(),
            qs_t.data_ptr(), meta.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            t_max, nlist, lmax, d, int(metric == "L2"), int(vec4),
            out.data_ptr(),
            torch.cuda.current_stream(lists.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_pairs_scan: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return out


def check_pairs(fn, lists, counts, xq_t, qs_t, meta, mask, metric):
    """Checks shared by the K7 and K10 wrappers."""
    check_lists(fn, lists, counts, mask, metric)
    dev = lists.device
    expect(fn, "xq_t", xq_t, (torch.float32,), (None, QG, lists.shape[2]),
           dev)
    t_max = xq_t.shape[0]
    expect(fn, "qs_t", qs_t, (torch.float32,), (t_max, QG, 4), dev)
    expect(fn, "meta", meta, (torch.int32,), (1 + t_max,), dev)


def pairs_flat_epilogue(raw, lists, pair_slot, probe_ids, row_pos, xq, *,
                        k, k_scan, metric):
    """Inverse pair gather, top-``k_scan`` per query, fp32 re-score of the
    selection in difference form (IP: the elementwise dot), then top-k."""
    t_max, qg, lmax = raw.shape
    nq, nprobe = probe_ids.shape
    pv = raw.reshape(t_max * qg, lmax)[pair_slot.reshape(-1).long()] \
        .reshape(nq, nprobe * lmax)
    k_scan = min(k_scan, nprobe * lmax)
    best, sel = exact_topk(pv, k_scan)
    lane = sel % lmax
    lids = probe_ids.long().gather(1, sel // lmax)
    pos = torch.where(torch.isneginf(best), -1, row_pos[lids, lane])
    xs = lists[lids, lane]                                  # (nq, k_scan, d)
    if metric == "INNER_PRODUCT":
        s2 = (xs * xq[:, None, :]).sum(-1)
    else:
        diff = xs - xq[:, None, :]
        s2 = -(diff * diff).sum(-1)
    s2 = torch.where(torch.isneginf(best), _NEG_INF, s2)
    best, sel2 = exact_topk(s2, k)
    pos = pos.gather(1, sel2)
    return best, torch.where(torch.isneginf(best), -1, pos)


def pair_tiles(probe_ids, nlist: int):
    """The tile table of a batch for the pair-tile kernels (K7, K3):
    (tile_q (t_max, QG), meta (1 + t_max,) = n_tiles and the tiles' list
    ids, pair_slot (nq, nprobe)), with t_max the static worst case rounded
    up to a multiple of TILE_ROUND."""
    nq, nprobe = probe_ids.shape
    t_max = pairs_t_max(nq, nprobe, nlist)
    t_max = -(-t_max // TILE_ROUND) * TILE_ROUND
    tile_list, tile_q, pair_slot, n_tiles = build_pair_tiles(
        probe_ids, nlist=nlist, t_max=t_max)
    return tile_q, torch.cat([n_tiles.reshape(1), tile_list]), pair_slot


def pair_tile_inputs(probe_ids, xq, nlist: int):
    """The kernel's inputs for a batch: (xq_t (t_max, QG, d), qs_t (t_max,
    QG, 4), meta (1 + t_max,), pair_slot (nq, nprobe)) over the
    ``pair_tiles`` table."""
    tile_q, meta, pair_slot = pair_tiles(probe_ids, nlist)
    safe_q = tile_q.clamp(min=0).long()
    xq_t = xq[safe_q]                                       # (t_max, qg, d)
    qn = (xq * xq).sum(1)
    zeros = torch.zeros_like(tile_q, dtype=torch.float32)
    bias = torch.where(tile_q < 0, _NEG_INF, 0.0).to(torch.float32)
    qs_t = torch.stack([bias, qn[safe_q], zeros, zeros], 2).contiguous()
    return xq_t, qs_t, meta, pair_slot


def ivf_pairs_search(lists, counts, row_pos, probe_ids, xq, mask, *, k,
                     k_scan, metric, mega=False):
    """``pallas_ivf_pairs_search``'s contract: (scores (nq, k) max-oriented
    with -inf missing, positions (nq, k) int32 original rows, -1
    missing).  ``mega`` scans the tiles with K10 (ops/ivf_pairs_mega.py)
    in place of K7."""
    xq_t, qs_t, meta, pair_slot = pair_tile_inputs(probe_ids, xq,
                                                   lists.shape[0])
    if mega:
        from .ivf_pairs_mega import ivf_pairs_mega_scan as scan
    else:
        scan = ivf_pairs_scan
    raw = scan(lists, counts, xq_t, qs_t, meta, mask, metric)
    return pairs_flat_epilogue(raw, lists, pair_slot, probe_ids, row_pos, xq,
                               k=k, k_scan=k_scan, metric=metric)
