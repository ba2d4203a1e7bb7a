"""Pair-tile IVF,Flat search (K7): the hand-written CUDA kernels
``csrc/ivf_pairs.cu`` over the 3xTF32 pair core ``csrc/pairs_tf32.cuh``,
their wrappers, their plain torch versions, and the pair table around
them.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
_pairs_flat_kernel`` together with what its wrapper
``pallas_ivf_pairs_search`` ran around it (``_pairs_flat_epilogue``).  Each
query probes different lists, so a batch cannot share list reads per
query; it can per list.  The (nq, nprobe) probe map is inverted into tiles
of one list and ``QG`` = 8 queries (``build_pair_tiles``).  The contract:
each query's ``k_scan`` best live slots (row below the list's count, mask
byte not 0) by the expansion-form score (inner product ``x·q``, L2
``-max(‖q‖² − 2x·q + ‖x‖², 0)``, as the TPU kernel computes it), ties to
the lower flat index (probe slot · lmax + row): the pool; the pool
rescored in fp32 difference form (IP the elementwise dot, L2 ``-Σ(x−q)²``)
and the best k of it, ties by pool order, positions through ``row_pos``.

Two designs:

* ``ivf_pairs_search`` for k_scan ≤ ``MAX_K_SCAN`` (1024): the fused
  search, two launches in one C call (``TopKLaunch``).  Work items
  (``pair_items``, built on the device): a run of up to T tiles of one list
  (8T queries) times a share of up to ``SHARE_ROWS`` of its live rows, so
  a list is read about once a batch and a long list runs on several SMs.
  The partial streams an item's rows and queries through shared memory in
  128-row x 32-dim chunks, runs the dots on the TF32 tensor cores with the
  3xTF32 split (``mma.sync m16n8k8``, each row fragment serving T query
  fragments), and keeps each query slot's best k_scan (score, flat index);
  the merge, a warp a query, merges its (probe slot, share) lists into the
  pool, rescores it exactly in fp32 (a lane a row, in dimension order),
  sorts and resolves.  No raw block and no (nq, nprobe · lmax) gather is
  written.  ``walk`` is the plain version of that algorithm; the merge
  counts the margin-unproven queries (``unproven``).  Under ``mega`` the
  same items go through K10 (ops/ivf_pairs_mega.py), bit-equal.
* ``ivf_pairs_scan``, the raw launch (the port's first design): raw
  (t_max, qg, lmax) tile scores, inner product ``x·q + bias``, L2
  ``-max(‖q‖² − 2x·q + ‖x‖², 0) + bias`` with ``bias`` -inf on empty
  query slots, -inf at or beyond the count or where the mask byte is 0,
  tiles at or beyond ``n_tiles`` (``meta[0]``, read on the device)
  unwritten.  Above ``MAX_K_SCAN`` the search takes it with
  ``pairs_flat_epilogue`` (``ivf_pairs_search_raw``), as the JAX package
  does outside its ``pallas_call``; it is the fused search's "before"
  when the two are timed in turns.

What bounds it on the H100: the distinct probed lists' rows, each read
once (1.6 GB at IVF1024 262,144 x 1536, nprobe 16, b1024: 0.48 ms); the
3xTF32 products (3 · 2 · d a scored (query, row) pair) stay below that.

The wrappers launch the kernels for CUDA tensors and raise on what the
kernels do not take; they take the plain versions only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.config import next_pow2
from ..utils.kernels import DeviceCounter
from ..utils.profiling import span, spanned
from .flat_search import exact_topk, topk_ordered
from .ivf_list_scan import check_lists, expect

#: launches of the raw CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0
#: fused searches launched on the card through K7 since import (or since a
#: caller reset it): one for each ``TopKLaunch.run`` of both launches
TOPK_LAUNCHES = 0

#: queries per tile (the TPU version's MXU sublane batch; here the number
#: of dot products each thread keeps in registers)
QG = 8

#: t_max is rounded up to a multiple of this, as the JAX package rounds it
#: to its tiles per grid step (at most 4)
TILE_ROUND = 4

_NEG_INF = float("-inf")

#: largest k_scan (the pool a query keeps) the fused search takes
MAX_K_SCAN = 1024
#: rows of a list an item scores at most: a multiple of the row tile
SHARE_ROWS = 512
#: stages of a launch (bits of ``TopKLaunch.run``'s argument)
PARTIAL, MERGE = 1, 2
#: the C interface's plan, in csrc/pairs_tf32.cuh::Plan's order
PLAN_FIELDS = ("nq", "nprobe", "nlist", "lmax", "d", "k", "k2", "tiles",
               "share_rows", "shares", "items", "slots", "stages",
               "merge_slots", "merge_warps", "smem", "merge_smem", "l2",
               "vec4", "tma")
_ROW_TILE, _DK, _LD = 128, 32, 36   # rows a row tile, dims a chunk, stride
_THREADS = 256                      # consumer threads of a partial block
_TILES = (4, 2, 1)                  # T: tiles an item, the most that fit
_STAGES, _MAX_RING = 3, 8           # K7's ring; K10's deepest
_SMEM_MAX, _SM_SMEM = 227 * 1024, 228 * 1024   # a block's, an SM's
_MERGE_SMEM = 96 * 1024

#: per device, the count of margin-unproven queries of the fused K7 and
#: K10 searches, added to by every merge until a caller zeroes it
_UNPROVEN = DeviceCounter()


def pairs_t_max(nq: int, nprobe: int, nlist: int, qg: int = QG) -> int:
    """Static worst-case tile count: every list's pairs fill
    ``floor(npair/qg)`` whole tiles at most, plus at most one partial
    tile per active list."""
    npair = nq * nprobe
    return npair // qg + min(nlist, npair)


def list_pairs(lists: torch.Tensor, nlist: int) -> torch.Tensor:
    """(nlist,) int64 count of the pairs on each list: ``torch.bincount``'s
    result without its host round trip (it reads the ids' minimum and
    maximum back on a CUDA tensor)."""
    return torch.zeros(nlist, dtype=torch.int64, device=lists.device) \
        .scatter_add_(0, lists, torch.ones_like(lists))


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
    order = torch.argsort(lists, stable=True)
    sl = lists[order]
    m = list_pairs(lists, nlist)
    tiles_pl = (m + qg - 1) // qg
    start_tile = tiles_pl.cumsum(0) - tiles_pl
    r = torch.arange(npair, device=dev) - (m.cumsum(0) - m)[sl]
    tile = start_tile[sl] + r // qg
    slot = r % qg
    tile_q = torch.full((t_max, qg), -1, dtype=torch.int32, device=dev)
    tile_q[tile, slot] = (order // nprobe).to(torch.int32)
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


@spanned("kernels.ivf_pairs")
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
    best, sel = exact_topk(pv, min(k_scan, nprobe * lmax))
    return rescore_pool(best, sel, lists, probe_ids, row_pos, xq, k=k,
                        metric=metric)


def rescore_pool(best, sel, lists, probe_ids, row_pos, xq, *, k, metric):
    """The epilogue's tail: the pool (scores ``best``, flat indices
    ``sel``, (nq, k_scan)) rescored in fp32 difference form, its best k by
    that score (ties by pool order), positions through ``row_pos``; -inf
    / -1 where the pool's score is -inf."""
    lmax = lists.shape[1]
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


def ivf_pairs_search_raw(lists, counts, row_pos, probe_ids, xq, mask, *, k,
                         k_scan, metric, mega=False):
    """The search above the fused search's k_scan limit, and the design
    the fused search replaced: the raw tile launch (K7's, or K10's under
    ``mega``) and ``pairs_flat_epilogue``."""
    xq_t, qs_t, meta, pair_slot = pair_tile_inputs(probe_ids, xq,
                                                   lists.shape[0])
    if mega:
        from .ivf_pairs_mega import ivf_pairs_mega_scan as scan
    else:
        scan = ivf_pairs_scan
    raw = scan(lists, counts, xq_t, qs_t, meta, mask, metric)
    return pairs_flat_epilogue(raw, lists, pair_slot, probe_ids, row_pos, xq,
                               k=k, k_scan=k_scan, metric=metric)


def _lists_bytes(qt: int, slots: int) -> int:
    """Shared-memory bytes of a partial block's consumer state
    (pairs_tf32.cuh::lists_bytes)."""
    return 4 * (2 * _ROW_TILE + _THREADS + 6 * qt) + 8 * qt * slots + _ROW_TILE


def _grid_smem(tiles: int, stages: int, slots: int) -> int:
    """K7's partial: the ring (rows and queries at the padded stride),
    then the consumer state."""
    qt = QG * tiles
    return 4 * stages * (_ROW_TILE + qt) * _LD + _lists_bytes(qt, slots)


def _mega_smem(tiles: int, tma: bool, stages: int, slots: int) -> int:
    """K10's partial (ivf_pairs_mega.cu::mega_smem): 1 KB of alignment,
    the stages (TMA: dense swizzled rows, 1024-byte aligned), the consumer
    state, a 16-byte header and two barriers a stage."""
    qt = QG * tiles
    if tma:
        stage = -(-(4 * _ROW_TILE * _DK + 4 * qt * _LD) // 1024) * 1024
    else:
        stage = 4 * (_ROW_TILE + qt) * _LD
    return 1024 + stages * (stage + 32) + _lists_bytes(qt, slots)


def plan(nq: int, nprobe: int, nlist: int, lmax: int, d: int, k: int,
         k_scan: int, metric: str, *, mega: bool = False, tma: bool = False,
         vec4: bool = False) -> dict:
    """The fused search's launch shape: k2 = k_scan capped at the probed
    slots; T tiles an item, the most (4, 2 or 1) whose query slots' lists
    (k2 + 64 slots each, a power of two) fit a block beside its ring; a
    static bound on the items of any probe table (``pair_items``: at most
    npair / (8T) + min(nlist, npair) runs, each of at most ceil(lmax / S)
    shares), K7's grid; K7's 3-stage ring (two blocks an SM at k_scan 42);
    K10's deepest ring (up to 8 stages) that keeps two blocks on an SM,
    else the deepest for one: a second block hides one block's top-k
    epilogue behind its own copies and products, which a deeper ring does
    not (tools/pairs_plans.py times both); the merge's lists of k2 +
    max(k2, 32) slots and its warps a block."""
    k2 = min(k_scan, nprobe * lmax)
    slots = next_pow2(k2 + 64)
    tiles = next((t for t in _TILES
                  if _grid_smem(t, _STAGES, slots) <= _SMEM_MAX
                  and _mega_smem(t, tma, 2, slots) <= _SMEM_MAX), None)
    if tiles is None:
        raise ValueError(f"k_scan = {k2} does not fit a partial block's "
                         f"shared memory")
    if mega:
        fit = [s for s in range(2, _MAX_RING + 1)
               if _mega_smem(tiles, tma, s, slots) <= _SMEM_MAX]
        two = [s for s in fit
               if 2 * (_mega_smem(tiles, tma, s, slots) + 1024) <= _SM_SMEM]
        stages = max(two or fit)
        smem = _mega_smem(tiles, tma, stages, slots)
    else:
        stages, smem = _STAGES, _grid_smem(tiles, _STAGES, slots)
    shares = -(-lmax // SHARE_ROWS)
    npair = nq * nprobe
    items = (npair // (QG * tiles) + min(nlist, npair)) * shares
    merge_slots = next_pow2(k2 + max(k2, 32))
    merge_warps = max(1, min(8, _MERGE_SMEM // (12 * merge_slots)))
    return {"nq": nq, "nprobe": nprobe, "nlist": nlist, "lmax": lmax, "d": d,
            "k": k, "k2": k2, "tiles": tiles, "share_rows": SHARE_ROWS,
            "shares": shares, "items": items, "slots": slots,
            "stages": stages, "merge_slots": merge_slots,
            "merge_warps": merge_warps, "smem": smem,
            "merge_smem": 12 * merge_slots * merge_warps,
            "l2": int(metric == "L2"), "vec4": int(vec4), "tma": int(tma)}


def pair_items(probe_ids, counts, p: dict):
    """The fused search's work items as tables built on the probe ids'
    device with no host round trip: (order, ends, item_list, head).  The
    pairs (query, probe slot), flattened q · nprobe + j, sorted stably by
    list (``order``, int64: build_pair_tiles' order) are cut into runs of
    up to QG · p["tiles"] pairs of one list (T tiles of QG queries); an
    item is a run times one of its list's shares of ``share_rows`` live
    rows (none for an empty list).  ``ends`` (2, nlist) int32 holds the
    inclusive prefix sums over the lists of their pairs and of their
    items, ``item_list`` (p["items"],) int32 each item's list (nlist past
    the last item), ``head`` (4,) int32 zeros (K10's item counter and the
    largest |x|²).  ``items_of`` reads the items back."""
    nlist, lmax = p["nlist"], p["lmax"]
    lists = probe_ids.reshape(-1)
    order = torch.argsort(lists, stable=True)
    m = list_pairs(lists.long(), nlist)
    shares = (counts.clamp(0, lmax) + p["share_rows"] - 1) // p["share_rows"]
    width = QG * p["tiles"]
    ends = torch.empty((2, nlist), dtype=torch.int32, device=lists.device)
    torch.cumsum(m, 0, dtype=torch.int32, out=ends[0])
    torch.cumsum((m + width - 1) // width * shares, 0, dtype=torch.int32,
                 out=ends[1])
    item_list = torch.searchsorted(
        ends[1], torch.arange(p["items"], dtype=torch.int32,
                              device=lists.device), right=True,
        out_int32=True)
    head = torch.zeros(4, dtype=torch.int32, device=lists.device)
    return order, ends, item_list, head


def items_of(tables, counts, p: dict):
    """The live items of ``pair_items``' tables, as the kernels read them
    (pairs_tf32.cuh::item_at): (first sorted pair, pairs, list, share),
    each (n_items,) int64.  Reads the item count back (a host round
    trip: for the plain walk and tests, not the card path)."""
    _, ends, item_list, _ = tables
    n = int(ends[1, -1])
    width = QG * p["tiles"]
    lid = item_list[:n].long()
    zero = ends.new_zeros((2, 1))
    starts = torch.cat([zero, ends[:, :-1]], 1).long()
    u = torch.arange(n, device=lid.device) - starts[1, lid]
    cnt = counts.long().clamp(0, p["lmax"])[lid]
    shares = ((cnt + p["share_rows"] - 1) // p["share_rows"]).clamp(min=1)
    run = u // shares
    first = starts[0, lid] + run * width
    npairs = (ends[0].long()[lid] - first).clamp(max=width)
    return first, npairs, lid, u - run * shares


def pair_scores(lists, counts, probe_ids, xq, mask, metric):
    """(nq, nprobe, lmax) expansion-form score of every slot of every
    (query, probed list) pair, -inf where the slot is not live: the raw
    tiles' plain version gathered back to the pairs."""
    nq, nprobe = probe_ids.shape
    xq_t, qs_t, meta, pair_slot = pair_tile_inputs(probe_ids, xq,
                                                   lists.shape[0])
    raw = ivf_pairs_scan_reference(lists, counts, xq_t, qs_t, meta, mask,
                                   metric)
    return raw.reshape(-1, lists.shape[1])[pair_slot.reshape(-1).long()] \
        .reshape(nq, nprobe, -1)


def walk(lists, counts, row_pos, probe_ids, xq, mask, *, k, k_scan, metric):
    """Plain walk of the fused search (K7's and K10's: the same items) on
    ``plan``'s shapes and ``pair_items``' items: each (pair, share) list an
    item writes, the best
    k2 of its slots by the plain fp32 expansion-form score (ties to the
    lower flat index); the merge of a query's lists into the pool; the
    exact rescore, sort and resolve (``rescore_pool``).  A (pair, share)
    that no item covers contributes nothing.  Returns (scores (nq, k),
    positions (nq, k))."""
    nlist, lmax, d = lists.shape
    nq, nprobe = probe_ids.shape
    p = plan(nq, nprobe, nlist, lmax, d, k, k_scan, metric)
    k2, rows, shares = p["k2"], p["share_rows"], p["shares"]
    tables = pair_items(probe_ids, counts, p)
    first, npairs, _, share = items_of(tables, counts, p)
    c = torch.arange(QG * p["tiles"], device=lists.device)
    live = c[None, :] < npairs[:, None]
    pair = tables[0][(first[:, None] + c).clamp(max=nq * nprobe - 1)]
    made = torch.zeros((nq * nprobe, shares), dtype=torch.bool,
                       device=lists.device)
    made[pair[live], share[:, None].expand_as(pair)[live]] = True
    made = made.reshape(nq, nprobe, shares)
    sc = pair_scores(lists, counts, probe_ids, xq, mask, metric)
    sc = torch.cat([sc, sc.new_full((nq, nprobe, shares * rows - lmax),
                                    _NEG_INF)], 2)
    sc = torch.where(made[..., None], sc.reshape(nq, nprobe, shares, rows),
                     _NEG_INF)
    slot = torch.arange(shares * rows, device=lists.device)
    flat = (torch.arange(nprobe, device=lists.device)[:, None] * lmax
            + slot[None, :]).reshape(1, nprobe, shares, rows).expand_as(sc)
    s, f = topk_ordered(sc.reshape(-1, rows), flat.reshape(-1, rows), k2)
    best, sel = topk_ordered(s.reshape(nq, -1), f.reshape(nq, -1), k2)
    best, pos = rescore_pool(best, sel, lists, probe_ids, row_pos, xq, k=k,
                             metric=metric)
    return best, pos.to(torch.int32)


def ivf_pairs_search_reference(lists, counts, row_pos, probe_ids, xq, mask,
                               *, k, k_scan, metric):
    """Plain version of ``ivf_pairs_search`` on any device: the raw tiles'
    plain version and ``pairs_flat_epilogue``."""
    nq, nprobe = probe_ids.shape
    sc = pair_scores(lists, counts, probe_ids, xq, mask, metric)
    best, sel = exact_topk(sc.reshape(nq, -1), min(k_scan, nprobe *
                                                   lists.shape[1]))
    return rescore_pool(best, sel, lists, probe_ids, row_pos, xq, k=k,
                        metric=metric)


def unproven(dev) -> int:
    """Queries the fused K7 and K10 merges counted unproven on ``dev``
    since the last reset (reads the card: a synchronisation)."""
    return _UNPROVEN.read(dev)


def reset_unproven(dev) -> None:
    _UNPROVEN.reset(dev)


def tma_ok(lists, xq) -> bool:
    """Whether K10's producer may copy rows with TMA boxes and queries in
    16-byte pieces: d a multiple of 4 and lists and queries 16-byte
    aligned (otherwise its cp.async instance runs)."""
    return (lists.shape[2] % 4 == 0 and lists.data_ptr() % 16 == 0
            and xq.data_ptr() % 16 == 0)


def _check_search(lists, counts, row_pos, probe_ids, xq, mask, k, k_scan,
                  metric):
    """Raise unless the fused search takes these inputs."""
    fn = "ivf_pairs_search"
    check_lists(fn, lists, counts, mask, metric)
    nlist, lmax, d = lists.shape
    dev = lists.device
    expect(fn, "row_pos", row_pos, (torch.int32,), (nlist, lmax), dev)
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, nprobe = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, d), dev)
    if nprobe < 1 or nprobe * lmax + 64 >= 2 ** 31 or nlist * lmax >= 2 ** 31:
        raise ValueError(f"{fn}: {nprobe} probes x {lmax} slots do not fit "
                         f"int32 flat indices")
    if not 1 <= k <= min(k_scan, nprobe * lmax) <= MAX_K_SCAN:
        raise ValueError(f"{fn}: k = {k}, k_scan = {k_scan} outside 1 <= k "
                         f"<= k_scan <= {MAX_K_SCAN}")


class TopKLaunch:
    """One fused ``ivf_pairs_search`` call on the card (K7, or K10 under
    ``mega``), checked and planned: the item tables (``pair_items``, built
    on the device), one workspace for the (pair, share) candidate lists,
    and the outputs (``scores``, ``positions``).  ``run(stages)``
    launches the named stages on the current stream (both by default).
    ``tma`` picks K10's copies (default: TMA where ``tma_ok``)."""

    def __init__(self, lists, counts, row_pos, probe_ids, xq, mask, *, k,
                 k_scan, metric, mega=False, tma=None):
        _check_search(lists, counts, row_pos, probe_ids, xq, mask, k, k_scan,
                      metric)
        nlist, lmax, d = lists.shape
        nq, nprobe = probe_ids.shape
        dev = lists.device
        vec4 = tma_ok(lists, xq)
        if tma is None:
            tma = mega and vec4
        if tma and not (mega and vec4):
            raise ValueError("ivf_pairs_search: TMA copies need K10, d a "
                             "multiple of 4 and 16-byte aligned lists and "
                             "queries")
        self.mega = mega
        self.plan = p = plan(nq, nprobe, nlist, lmax, d, k, k_scan, metric,
                             mega=mega, tma=tma, vec4=vec4)
        self.tables = pair_items(probe_ids, counts, p)
        n_part = nq * nprobe * p["shares"] * p["k2"]
        ws = torch.empty(2 * n_part, dtype=torch.float32, device=dev)
        self.part_s, self.part_p = ws[:n_part], ws[n_part:].view(torch.int32)
        self.scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
        self.positions = torch.empty((nq, k), dtype=torch.int32, device=dev)
        self.plan_ints = (ctypes.c_int * len(PLAN_FIELDS))(
            *(int(p[f]) for f in PLAN_FIELDS))
        self._dev = dev
        self._args = (
            lists.data_ptr(), counts.data_ptr(), row_pos.data_ptr(),
            probe_ids.data_ptr(), xq.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            *(t.data_ptr() for t in self.tables), self.plan_ints,
            self.part_s.data_ptr(),
            self.part_p.data_ptr(), self.scores.data_ptr(),
            self.positions.data_ptr(), _UNPROVEN.tensor(dev).data_ptr())
        # The tensors behind the pointers live as long as this launch.
        self._keep = (lists, counts, row_pos, probe_ids, xq, mask, ws)

    def run(self, stages: int = PARTIAL | MERGE) -> None:
        from ..utils.kernels import load_library

        if self.plan["nq"] == 0:
            return
        lib = load_library()
        with torch.cuda.device(self._dev):
            stream = torch.cuda.current_stream(self._dev).cuda_stream
            if self.mega:
                from . import ivf_pairs_mega as k10

                grid = (ctypes.c_int * 1)()
                err = lib.dfx_ivf_pairs_mega_topk(*self._args, grid, stages,
                                                  stream)
                k10.last_plan = (self.plan["stages"], grid[0],
                                 bool(self.plan["tma"]))
            else:
                err = lib.dfx_ivf_pairs_topk(*self._args, stages, stream)
        if err != 0:
            raise RuntimeError(f"ivf_pairs_search: CUDA launch failed with "
                               f"error {err}")


def ivf_pairs_search(lists, counts, row_pos, probe_ids, xq, mask, *, k,
                     k_scan, metric, mega=False):
    """``pallas_ivf_pairs_search``'s contract: (scores (nq, k) max-oriented
    with -inf missing, positions (nq, k) int32 original rows, -1
    missing).  On CUDA tensors the fused search (K7, or K10 under
    ``mega``) for k <= k_scan <= MAX_K_SCAN (k_scan capped at the probed
    slots), and otherwise ``ivf_pairs_search_raw``; on CPU tensors
    ``ivf_pairs_search_raw``, whose tile scans take their plain version
    there (the plain version of the whole, as
    ``ivf_pairs_search_reference`` computes it on any device)."""
    global TOPK_LAUNCHES
    with span("kernels.ivf_pairs_mega" if mega else "kernels.ivf_pairs"):
        on_cpu = all(t.device.type == "cpu" for t in (lists, counts, row_pos,
                                                      probe_ids, xq))
        pool = min(k_scan, probe_ids.shape[1] * lists.shape[1])
        if on_cpu or not 1 <= k <= pool <= MAX_K_SCAN:
            return ivf_pairs_search_raw(lists, counts, row_pos, probe_ids,
                                        xq, mask, k=k, k_scan=k_scan,
                                        metric=metric, mega=mega)
        launch = TopKLaunch(lists, counts, row_pos, probe_ids, xq, mask, k=k,
                            k_scan=k_scan, metric=metric, mega=mega)
        if probe_ids.shape[0] > 0:
            launch.run()
            if mega:
                from . import ivf_pairs_mega as k10

                k10.TOPK_LAUNCHES += 1
            else:
                TOPK_LAUNCHES += 1
        return launch.scores, launch.positions
