"""Host side of the per-query list scans that end in their top-k
(``csrc/list_topk.cuh``): the launch plan, the workspace, and the plain
walk of the skeleton's own algorithm, shared by the fused IVF,Flat search
(K6, ops/ivf_list_scan.py) and the fused IVF,SQ search (K2,
ops/ivf_sq_scan.py).

The partial launch runs queries x splits: a query's probed lists' live
rows, cut into chunks of up to 32 rows in probe-slot order, are shared out
equally among its splits (a split may start or end inside a list); a
block's producer warp hands its chunks to the consumer warps (item i to
warp i % warps), each warp keeps its best k2 (score, flat index = probe
slot · lmax + slot), and the block merges its warps' lists; the merge
launch merges a query's splits.  ``parts`` and ``walk_candidates`` are the
plain version of that: the same (split, warp) partition of the rows, each
part's best k2, and their merge.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.config import next_pow2
from .flat_search import topk_ordered

#: largest k (K6) or k_scan (K2) the fused searches take
MAX_K = 1024
#: stages of a launch (bits of ``run``'s argument)
PARTIAL, MERGE = 1, 2

#: the C interface's plan, in csrc/list_topk.cuh::Plan's order
PLAN_FIELDS = ("nq", "nprobe", "nlist", "lmax", "row_bytes", "k", "k2",
               "splits", "chunk_rows", "stage_bytes", "stages",
               "warps", "slots", "merge_slots", "merge_warps", "tma", "smem",
               "merge_smem")
CHUNK_ROWS = 32            # rows a chunk at most: one a lane
_CHUNK_BYTES = 12 * 1024   # a chunk's bytes at most, unless one row is larger
_DEPTH, _WARPS = 2, 4      # stages a consumer warp, consumer warps a block
_BLOCKS_PER_SM = 4         # partial blocks a split plan aims at, per SM
_SMEM_MAX = 227 * 1024
_ITEM_BYTES, _BAR_BYTES = 32, 8
_NEG_INF = float("-inf")


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def partial_smem(stages: int, stage_bytes: int, warps: int, slots: int,
                 extra: int) -> int:
    """Shared-memory bytes of the partial launch: the ring (stages, items,
    two barriers each), the warps' lists, then the functor's ``extra``
    bytes, 16-byte aligned."""
    head = (stages * (stage_bytes + _ITEM_BYTES + 2 * _BAR_BYTES)
            + 8 * warps * slots)
    return _up16(head) + extra


def plan(*, nq: int, nprobe: int, nlist: int, lmax: int, row_bytes: int,
         k: int, k2: int, n_sm: int, extra: int, tma: bool,
         merge_warps: int, merge_extra: int) -> dict:
    """The launch shape: chunks of up to 32 rows of at most 12 KB (one row
    where a row is larger), in stages 32 bytes larger for the 16-byte
    rounding; four consumer warps with two stages each (fewer where shared
    memory runs out; at d = 128 a block takes 100 KB and two share an SM);
    splits so that a small batch still gives each SM about four blocks
    (at most four a probe slot), one a query at b1024; a warp's list of k2
    + 32 slots and the merge's of k2 + max(k2, 32), powers of two.  The sizes were
    measured by tools/list_topk_plans.py."""
    chunk_rows = max(1, min(CHUNK_ROWS, _CHUNK_BYTES // row_bytes))
    stage_bytes = _up16(chunk_rows * row_bytes + 32)
    slots = next_pow2(k2 + 32)
    splits = max(1, min(4 * nprobe,
                        -(-_BLOCKS_PER_SM * n_sm // max(nq, 1))))
    depth, warps = _DEPTH, _WARPS
    while (partial_smem(depth * warps, stage_bytes, warps, slots, extra)
           > _SMEM_MAX and depth * warps > 1):
        if depth > 1:
            depth -= 1
        else:
            warps -= 1
    stages = depth * warps
    smem = partial_smem(stages, stage_bytes, warps, slots, extra)
    if smem > _SMEM_MAX:
        raise ValueError(f"rows of {row_bytes} bytes with k2 = {k2} do not "
                         f"fit a partial block's shared memory")
    merge_slots = next_pow2(k2 + max(k2, 32))
    return {"nq": nq, "nprobe": nprobe, "nlist": nlist, "lmax": lmax,
            "row_bytes": row_bytes, "k": k, "k2": k2, "splits": splits,
            "chunk_rows": chunk_rows, "stage_bytes": stage_bytes,
            "stages": stages, "warps": warps, "slots": slots,
            "merge_slots": merge_slots, "merge_warps": merge_warps,
            "tma": int(tma), "smem": smem,
            "merge_smem": 8 * merge_slots + merge_extra}


def tma_ok(payload: torch.Tensor) -> bool:
    """Whether bulk copies may stage the payload: its first and last byte
    on 16-byte boundaries (a chunk's copy is its bytes rounded out to 16)."""
    start = payload.data_ptr()
    return start % 16 == 0 and (start + payload.numel()
                                * payload.element_size()) % 16 == 0


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


class Workspace:
    """One launch's buffers on ``dev``: the splits' candidate lists
    (``part_s``, ``part_p``: (nq, splits, k2)), ``extra`` further (nq, k2)
    lists, and the results (``scores``, ``positions``: (nq, k)); the plan
    as the C interface takes it (``plan_ints``)."""

    def __init__(self, p: dict, dev, extra: int = 0):
        nq, k2 = p["nq"], p["k2"]
        n_part = nq * p["splits"] * k2
        n_extra = nq * k2
        self._ws = torch.empty(2 * n_part + 2 * extra * n_extra,
                               dtype=torch.float32, device=dev)
        self.part_s = self._ws[:n_part]
        self.part_p = self._ws[n_part:2 * n_part].view(torch.int32)
        self.lists = []
        at = 2 * n_part
        for _ in range(extra):
            s = self._ws[at:at + n_extra].view(nq, k2)
            pos = self._ws[at + n_extra:at + 2 * n_extra].view(
                torch.int32).view(nq, k2)
            self.lists.append((s, pos))
            at += 2 * n_extra
        self.scores = torch.empty((nq, p["k"]), dtype=torch.float32,
                                  device=dev)
        self.positions = torch.empty((nq, p["k"]), dtype=torch.int32,
                                     device=dev)
        self.plan_ints = (ctypes.c_int * len(PLAN_FIELDS))(
            *(int(p[f]) for f in PLAN_FIELDS))


def parts(counts: torch.Tensor, probe_ids: torch.Tensor, p: dict):
    """(nq, nprobe · lmax) the part (split · warps + warp) of the partial
    launch that scores each slot of each probed list (slots past the count
    fall anywhere): chunk g of a query's T chunks goes to split g // ceil(T
    / splits), and to warp i % warps as its split's i-th chunk."""
    nq, nprobe = probe_ids.shape
    lmax, nlist = p["lmax"], counts.shape[0]
    cr, warps = p["chunk_rows"], p["warps"]
    pids = probe_ids.long()
    live = (pids >= 0) & (pids < nlist)
    cnt = torch.where(live, counts[pids.clamp(0, nlist - 1)].long().clamp(
        0, lmax), 0)
    nch = (cnt + cr - 1) // cr
    per = ((nch.sum(1) + p["splits"] - 1) // p["splits"]).clamp(min=1)
    before = nch.cumsum(1) - nch                 # chunks before each list
    chunk = torch.arange(lmax, device=counts.device) // cr
    g = before[:, :, None] + chunk[None, None, :]
    split = g // per[:, None, None]
    return (split * warps + (g - split * per[:, None, None]) % warps).reshape(
        nq, -1)


def walk_candidates(scores: torch.Tensor, counts: torch.Tensor,
                    probe_ids: torch.Tensor, p: dict):
    """Plain walk of the partial and merge launches' candidates.
    ``scores`` (nq, nprobe · lmax) holds every slot's score, -inf where the
    slot is not live; each part (``parts``) keeps its best k2 by (score
    desc, flat index asc), and the parts merge into the best k2.  Returns
    (scores, flat indices) (nq, min(k2, nprobe · lmax)), -1 where
    missing."""
    nq = probe_ids.shape[0]
    part = parts(counts, probe_ids, p)
    flat = torch.arange(scores.shape[1], device=scores.device).expand(nq, -1)
    valid = scores > _NEG_INF
    cand_s, cand_p = [], []
    for prt in range(p["splits"] * p["warps"]):
        member = valid & (part == prt)
        s, f = topk_ordered(torch.where(member, scores, _NEG_INF),
                            torch.where(member, flat, -1), p["k2"])
        cand_s.append(s)
        cand_p.append(f)
    return topk_ordered(torch.cat(cand_s, 1), torch.cat(cand_p, 1), p["k2"])


def pad_to(scores: torch.Tensor, pos: torch.Tensor, k: int):
    """(scores, positions) padded with (-inf, -1) to k columns."""
    pad = k - scores.shape[1]
    if pad <= 0:
        return scores, pos
    return (torch.cat([scores, scores.new_full((scores.shape[0], pad),
                                               _NEG_INF)], 1),
            torch.cat([pos, pos.new_full((pos.shape[0], pad), -1)], 1))


def resolve(flat: torch.Tensor, scores: torch.Tensor, probe_ids, row_pos,
            lmax: int, offsets=None):
    """Storage rows of flat indices (probe slot · lmax + slot) through
    ``probe_ids`` and ``row_pos`` ((nlist, lmax); unpadded: (n,), list l's
    slots from ``offsets[l]``); -1 where the score is -inf or the index is
    missing."""
    nlist = row_pos.shape[0] if offsets is None else offsets.shape[0] - 1
    f = flat.clamp(min=0).long()
    lids = probe_ids.long().gather(1, f // lmax).clamp(0, nlist - 1)
    if offsets is None:
        pos = row_pos[lids, f % lmax]
    else:
        at = (offsets[lids].long() + f % lmax).clamp(max=max(
            row_pos.shape[0] - 1, 0))
        pos = row_pos[at] if row_pos.shape[0] else torch.full_like(at, -1)
    missing = (flat < 0) | torch.isneginf(scores)
    return torch.where(missing, -1, pos).to(torch.int32)
