"""Per-query IVF,Flat list search (K6): the hand-written CUDA kernels
``csrc/ivf_list_scan.cu``, their wrappers, and their plain torch versions.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
_scan_kernel`` together with what its wrapper ``pallas_ivf_search`` ran
around it (``exact_topk`` over the (nq, nprobe, lmax) score block and the
position resolve through ``row_pos``).  Lists are stored padded as (nlist,
lmax, d) fp32; a live slot (below its list's count, mask byte not 0)
scores max-oriented: inner product ``x·q``, L2 ``-Σ(x-q)²`` in difference
form, as the TPU kernel computes it.

Two designs:

* ``ivf_list_search`` for k ≤ ``MAX_K`` (1024): the fused search, two
  launches in one C call over one workspace (``TopKLaunch``), on the
  skeleton of ``csrc/list_topk.cuh`` (host side ops/list_topk.py): a
  partial launch over queries x splits (equal shares of a query's row
  chunks) streams each probed list's live rows through shared memory (TMA
  bulk copies from a producer warp) to consumer warps that score them,
  lanes along d (``lanes`` a row: up to 8 for rows of up to 1 KB, 32 for
  wider ones, so d = 8 no longer idles 30 lanes and d = 128 keeps its
  reduction short), and keep the best k (score, flat index) a warp; a
  merge launch, a warp a query, merges the splits' lists and resolves
  positions.  No score block is written; each
  row's score is one fixed sum, so no rescore is needed.
* ``ivf_list_scan``, the raw launch: the scores of all lmax slots of every
  (query, probed list), -inf where a slot is not live, as the TPU kernel
  wrote them.  Above ``MAX_K`` the search takes it with ``exact_topk`` and
  the resolve (a stated route, as K8's gather path above its limit); the
  tests and ``chip_smoke.py`` use it, and it is the fused search's "before"
  when the two are timed in turns.

What bounds it on the H100: the probed lists' bytes, each read once
(~512 MB at IVF4096 1M x 128, nprobe 64, b1024: 0.15 ms); a per-query
scan reads a list once for each query that probes it (8 GB there, most of
it from device memory: the queries of a batch seldom read a list at the
same time), which caps it well above that bound; sharing lists across
queries is the pair tiles' form (K7).  The raw launch also writes, and its
top-k reads back, the score block (403 MB at b1024, lmax 1536).

The wrappers launch the kernels for CUDA tensors and raise on what the
kernels do not take; they take the plain versions only for CPU tensors.
``walk`` is the plain version of the fused search's own algorithm (the
plan's splits and warps, the merge).
"""

from __future__ import annotations

import torch

from ..utils.config import next_pow2
from . import list_topk as lt
from .flat_search import exact_topk

#: launches of the raw CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0
#: fused searches launched on the card since import (or since a caller
#: reset it): one for each ``TopKLaunch.run`` of both launches
TOPK_LAUNCHES = 0
MAX_K = lt.MAX_K

METRICS = ("INNER_PRODUCT", "L2")
_NEG_INF = float("-inf")


def expect(fn: str, what: str, t: torch.Tensor, dtypes, shape,
           dev: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` and
    of ``shape`` (None matches any extent) on ``dev``."""
    if t.device != dev:
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    if (t.dtype not in dtypes or t.dim() != len(shape)
            or any(s is not None and s != n for s, n in zip(shape, t.shape))
            or not t.is_contiguous()):
        raise ValueError(f"{fn}: {what} must be a contiguous {shape} "
                         f"{dtypes[0]} tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")


def check_lists(fn: str, lists, counts, mask, metric) -> None:
    """Checks shared by the K6 and K7 wrappers: the padded list layout on
    one CUDA device."""
    dev = lists.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    expect(fn, "lists", lists, (torch.float32,), (None, None, None), dev)
    nlist, lmax, _ = lists.shape
    expect(fn, "counts", counts, (torch.int32,), (nlist,), dev)
    if mask is not None:
        expect(fn, "mask", mask, (torch.int8, torch.uint8, torch.bool),
               (nlist, lmax), dev)
    if metric not in METRICS:
        raise ValueError(f"{fn}: unsupported metric {metric}")


def ivf_list_scan_reference(lists, counts, probe_ids, xq, mask, metric):
    """Plain torch version: gather the probed list blocks, score, mask;
    chunked over queries so the gathered block stays under 2^26 floats
    (b1024 x nprobe 64 x lmax 1024 x d 128 unchunked is 34 GB)."""
    nlist, lmax, d = lists.shape
    nq, nprobe = probe_ids.shape
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=lists.device)
    lane = torch.arange(lmax, device=lists.device)
    qc = max(1, (1 << 26) // max(nprobe * lmax * d, 1))
    for q0 in range(0, nq, qc):
        pids = probe_ids[q0:q0 + qc].long()
        block = lists[pids]                                 # (qc, np, L, d)
        q = xq[q0:q0 + qc][:, None, None, :]
        if metric == "INNER_PRODUCT":
            s = (block * q).sum(-1)
        else:
            diff = block - q
            s = -(diff * diff).sum(-1)
        valid = lane < counts[pids][:, :, None]
        if mask is not None:
            valid = valid & (mask[pids] != 0)
        out[q0:q0 + qc] = torch.where(valid, s, _NEG_INF)
    return out


def ivf_list_scan(lists: torch.Tensor, counts: torch.Tensor,
                  probe_ids: torch.Tensor, xq: torch.Tensor,
                  mask: torch.Tensor | None, metric: str) -> torch.Tensor:
    """Raw (nq, nprobe, lmax) float32 scores of every slot of every probed
    list (see the module docstring)."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (lists, counts, probe_ids, xq)):
        return ivf_list_scan_reference(lists, counts, probe_ids, xq, mask,
                                       metric)
    fn = "ivf_list_scan"
    check_lists(fn, lists, counts, mask, metric)
    nlist, lmax, d = lists.shape
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None),
           lists.device)
    nq, nprobe = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, d), lists.device)
    if nq * nprobe >= 2 ** 31:
        raise ValueError(f"{fn}: {nq} x {nprobe} pairs exceed the grid")
    from ..utils.kernels import load_library

    lib = load_library()
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=lists.device)
    if nq * nprobe == 0:
        return out
    vec4 = d % 4 == 0 and lists.data_ptr() % 16 == 0 \
        and xq.data_ptr() % 16 == 0
    with torch.cuda.device(lists.device):
        err = lib.dfx_ivf_list_scan(
            lists.data_ptr(), counts.data_ptr(), probe_ids.data_ptr(),
            xq.data_ptr(), mask.data_ptr() if mask is not None else None,
            nq, nprobe, nlist, lmax, d, int(metric == "L2"), int(vec4),
            out.data_ptr(),
            torch.cuda.current_stream(lists.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_list_scan: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return out


def ivf_list_search_reference(lists, counts, row_pos, probe_ids, xq, mask,
                              *, k, metric):
    """Plain version of ``ivf_list_search``: the raw score block, top-k
    over (probe slot, slot) with the lower flat index on ties, positions
    through ``row_pos``."""
    nq, nprobe = probe_ids.shape
    lmax = lists.shape[1]
    raw = ivf_list_scan_reference(lists, counts, probe_ids, xq, mask, metric)
    best, sel = exact_topk(raw.reshape(nq, nprobe * lmax), k)
    return best, lt.resolve(sel, best, probe_ids, row_pos, lmax)


def _shape(lists, xq):
    """(vec4, lanes) of the fused search: 16-byte units when d % 4 == 0 and
    lists and queries are 16-byte aligned, and lanes a row: the units
    rounded up to a power of two, at most 8 for rows of up to 1 KB and 32
    for wider ones.  A chunk of narrow rows holds a dozen of them or more,
    so 8 lanes a row (four rows a pass) spare the reduction three quarters
    of the shuffles 32 lanes a row would cost; a chunk of wide rows holds
    a row or two, which 32 lanes a row score in one pass each."""
    d = lists.shape[2]
    vec4 = (d % 4 == 0 and lists.data_ptr() % 16 == 0
            and xq.data_ptr() % 16 == 0)
    cap = 8 if 4 * d <= 1024 else 32
    return vec4, min(cap, next_pow2(d // 4 if vec4 else d))


def plan(nq, nprobe, nlist, lmax, d, k, n_sm, tma=True):
    """The fused search's launch shape (ops/list_topk.py::plan) with k2 =
    k, the query in the partial block's shared memory, a warp a merge."""
    return lt.plan(nq=nq, nprobe=nprobe, nlist=nlist, lmax=lmax,
                   row_bytes=4 * d, k=k, k2=k, n_sm=n_sm, extra=4 * d,
                   tma=tma, merge_warps=1, merge_extra=0)


def walk(lists, counts, row_pos, probe_ids, xq, mask, *, k, metric, n_sm):
    """Plain walk of the fused search on ``plan``'s shapes: each (split,
    warp)'s best k rows over the chunks the kernel hands it, their merge
    (ops/list_topk.py::walk_candidates), the resolve; the raw plain scores
    stand for the kernel's, as its scores are the results.  Returns
    (scores (nq, k), positions (nq, k))."""
    nlist, lmax, d = lists.shape
    nq, nprobe = probe_ids.shape
    p = plan(nq, nprobe, nlist, lmax, d, k, n_sm)
    raw = ivf_list_scan_reference(lists, counts, probe_ids, xq, mask,
                                  metric).reshape(nq, -1)
    s, flat = lt.walk_candidates(raw, counts, probe_ids, p)
    s, flat = lt.pad_to(s, flat, k)
    return s, lt.resolve(flat, s, probe_ids, row_pos, lmax)


def _check_search(lists, counts, row_pos, probe_ids, xq, mask, k, metric):
    """Raise unless the fused search takes these inputs."""
    fn = "ivf_list_search"
    check_lists(fn, lists, counts, mask, metric)
    nlist, lmax, d = lists.shape
    dev = lists.device
    expect(fn, "row_pos", row_pos, (torch.int32,), (nlist, lmax), dev)
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, nprobe = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, d), dev)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{fn}: k = {k} outside [1, {MAX_K}]")
    if nprobe < 1 or nprobe * lmax + 32 >= 2 ** 31:
        raise ValueError(f"{fn}: {nprobe} probes x {lmax} slots do not fit "
                         f"int32 flat indices")


class TopKLaunch:
    """One fused ``ivf_list_search`` call on the card, checked and planned:
    its outputs (``scores``, ``positions``) and one workspace holding the
    splits' candidate lists.  ``run(stages)`` launches the named stages on
    the current stream (both by default)."""

    def __init__(self, lists, counts, row_pos, probe_ids, xq, mask, *, k,
                 metric):
        _check_search(lists, counts, row_pos, probe_ids, xq, mask, k, metric)
        nlist, lmax, d = lists.shape
        nq, nprobe = probe_ids.shape
        dev = lists.device
        vec4, self.lanes = _shape(lists, xq)
        self.plan = p = plan(nq, nprobe, nlist, lmax, d, k, lt.sm_count(dev),
                             lt.tma_ok(lists))
        self._ws = ws = lt.Workspace(p, dev)
        self.scores, self.positions = ws.scores, ws.positions
        self._dev = dev
        self._args = (
            lists.data_ptr(), counts.data_ptr(), row_pos.data_ptr(),
            probe_ids.data_ptr(), xq.data_ptr(),
            mask.data_ptr() if mask is not None else None, ws.plan_ints, d,
            int(metric == "L2"), int(vec4), self.lanes, ws.part_s.data_ptr(),
            ws.part_p.data_ptr(), ws.scores.data_ptr(),
            ws.positions.data_ptr())
        # The tensors behind the pointers live as long as this launch.
        self._keep = (lists, counts, row_pos, probe_ids, xq, mask)

    def run(self, stages: int = lt.PARTIAL | lt.MERGE) -> None:
        from ..utils.kernels import load_library

        if self.plan["nq"] == 0:
            return
        with torch.cuda.device(self._dev):
            err = load_library().dfx_ivf_list_topk(
                *self._args, stages,
                torch.cuda.current_stream(self._dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ivf_list_search: CUDA launch failed with "
                               f"error {err}")


def ivf_list_search_raw(lists, counts, row_pos, probe_ids, xq, mask, *, k,
                        metric):
    """The search above the fused search's k limit, and the design the
    fused search replaced: the raw launch's (nq, nprobe, lmax) score
    block, ``exact_topk``, the resolve."""
    raw = ivf_list_scan(lists, counts, probe_ids, xq, mask, metric)
    best, sel = exact_topk(raw.reshape(probe_ids.shape[0], -1), k)
    return best, lt.resolve(sel, best, probe_ids, row_pos, lists.shape[1])


def ivf_list_search(lists, counts, row_pos, probe_ids, xq, mask, *, k,
                    metric):
    """``pallas_ivf_search``'s contract: (scores (nq, k) max-oriented with
    -inf missing, positions (nq, k) int32 original rows, -1 missing); equal
    scores to the lower flat index (probe slot · lmax + slot).  On CUDA
    tensors the fused search for k <= MAX_K, and above it
    ``ivf_list_search_raw``; on CPU tensors ``ivf_list_search_reference``."""
    global TOPK_LAUNCHES
    if all(t.device.type == "cpu" for t in (lists, counts, row_pos, probe_ids,
                                            xq)):
        return ivf_list_search_reference(lists, counts, row_pos, probe_ids,
                                         xq, mask, k=k, metric=metric)
    if k > MAX_K:
        return ivf_list_search_raw(lists, counts, row_pos, probe_ids, xq,
                                   mask, k=k, metric=metric)
    launch = TopKLaunch(lists, counts, row_pos, probe_ids, xq, mask, k=k,
                        metric=metric)
    if probe_ids.shape[0] > 0:
        launch.run()
        TOPK_LAUNCHES += 1
    return launch.scores, launch.positions
