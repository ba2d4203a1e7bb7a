"""IVF-PQ / IVF-RQ list search (K8): the hand-written CUDA kernels
``csrc/ivf_pq_scan.cu``, their wrapper, and their plain torch versions.

Replaces the TPU kernel ``duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
_gather_kernel`` (wrapper ``pallas_gather_lists``) together with what its
caller ``pallas_ivf_pq_search`` ran around it in XLA: for each query, the
k best (score, storage position) over its probed lists, max-oriented, each
row decoded as x = dec(code) + centroid[list] (by residual, faiss
IndexIVFPQ), with

* PQ: dec_j = cb[j // dsub][code[j // dsub]][j % dsub];
* RQ: dec_j = Σ_s cb[s][code_s][j], summed in stage order;
* inner product x·q, L2 −Σ(x − q)² in difference form;
* equal scores to the lower flat index (probe slot · lmax + slot), so to
  the lower storage row within a list; missing slots (-inf, -1).

The TPU kernel copied the probed code blocks into a compact buffer, which
XLA decoded and scored into an (nq, nprobe, lmax) score block for a top-k:
403 MB at b1024, nprobe 64, lmax 1536, read back by the top-k.  On the
H100 three launches (details in the CUDA source) score no decoded row and
write no score block:

(a) the table: each query's distance table (LUT-ADC), (nq, M, ksub) fp32;
(b) the partial scan: queries x probe splits, the table in shared memory,
    a lane a row summing its M table entries into the base + row term form,
    each warp keeping the best k + m rows by that score, a block's warps
    merged into one list;
(c) the merge: a warp a query merges its splits' lists, rescores the
    candidates exactly in the plain version's difference form, sorts them
    and resolves their positions.

All three are one C call (``Launch``), which can also run one stage at a
time.

The L2 table form needs each slot's row term ‖res‖² + 2⟨c, res⟩
(``pq_row_terms``), kept in the layout beside the codes.  ``margin`` (K1's
rule) gives m and ``error_bound`` the bound of the table score against the
exact one; the merge counts the queries whose (k + m)-th candidate lies
within twice that bound of the k-th exact score (``unproven``), a
diagnostic.

What bounds it on the H100: by bytes and operations some 0.01 ms at b1024
(the distinct probed lists' codes, row terms and centroids, the codebooks,
the queries and the result; the table build, M + 2 adds a probed row, the
rescore); in practice the shared-memory table lookups, M a probed row.

``ivf_pq_list_search`` launches the kernels for CUDA tensors and raises on
what they do not take; it takes the plain version (the raw score block of
``ivf_pq_scan_reference``, ``exact_topk``, the position resolve) only for
CPU tensors.  ``walk`` is the plain version of the kernels' own algorithm
(table scores, the plan's splits and warps, merge, rescore).
"""

from __future__ import annotations

import functools

import torch

from ..utils.config import full_fp32, next_pow2
from ..utils.kernels import DeviceCounter
from .flat_search import exact_topk, topk_ordered
from .flat_topk import margin
from .ivf_list_scan import METRICS, expect
from .pq import codec_decode

#: launches of the CUDA kernels since import (or since a caller reset it):
#: one for each ``ivf_pq_list_search`` call on the card (three launches)
LAUNCHES = 0

CODECS = ("pq", "rq")
MAX_K = 1024
_LUT_SMEM_MAX = 64 * 1024    # the table is staged in shared memory up to this
_SMEM_MAX = 227 * 1024
_BLOCKS_PER_SM = 4           # partial blocks a split plan aims at, per SM
_PPS_MAX = 256               # probed lists a partial block takes at most
_MAX_WARPS = 8
_MERGE_SMEM = 64 * 1024
_U = 2.0 ** -24
_NEG_INF = float("-inf")

#: per device, the count of unproven queries, added to by every launch
#: until a caller zeroes it (``reset_unproven``)
_UNPROVEN = DeviceCounter()


def gather_lists(lists: torch.Tensor, probe_ids: torch.Tensor):
    """The probed list blocks, (nlist, lmax, w) → (nq, nprobe, lmax, w): the
    plain counterpart of the TPU kernel's own function
    (``pallas_gather_lists``)."""
    return lists[probe_ids.long()]


def ivf_pq_scan_reference(lists, counts, probe_ids, xq, centroids, codebooks,
                          mask, metric, codec):
    """Raw (nq, nprobe, lmax) float32 scores of every slot of every probed
    list (-inf past the count or where the mask is 0): gather the probed
    code blocks, decode residual + probed centroid, score; chunked over
    queries so the decoded tile stays under 2^26 floats."""
    nlist, lmax, m = lists.shape
    nq, nprobe = probe_ids.shape
    d = xq.shape[1]
    out = torch.empty((nq, nprobe, lmax), dtype=torch.float32,
                      device=lists.device)
    lane = torch.arange(lmax, device=lists.device)
    qc = max(1, (1 << 26) // max(nprobe * lmax * d, 1))
    for q0 in range(0, nq, qc):
        pids = probe_ids[q0:q0 + qc].long()
        codes = gather_lists(lists, pids)                 # (qc, np, L, m)
        n = pids.shape[0]
        x = (codec_decode(codes.reshape(-1, m), codebooks, codec)
             .reshape(n, nprobe, lmax, d) + centroids[pids][:, :, None, :])
        q = xq[q0:q0 + qc][:, None, None, :]
        if metric == "INNER_PRODUCT":
            s = (x * q).sum(-1)
        else:
            diff = x - q
            s = -(diff * diff).sum(-1)
        valid = lane < counts[pids][:, :, None]
        if mask is not None:
            valid = valid & (mask[pids] != 0)
        out[q0:q0 + qc] = torch.where(valid, s, _NEG_INF)
    return out


def ivf_pq_list_search_reference(lists, counts, row_pos, codebooks,
                                 centroids, probe_ids, xq, mask, *, k,
                                 metric, codec, row_terms=None):
    """Plain version of ``ivf_pq_list_search``: the raw score block, top-k
    over (probe slot, slot) with the lower flat index on ties, positions
    through ``row_pos``.  ``row_terms`` is not read."""
    nq, nprobe = probe_ids.shape
    lmax = lists.shape[1]
    raw = ivf_pq_scan_reference(lists, counts, probe_ids, xq, centroids,
                                codebooks, mask, metric, codec)
    best, sel = exact_topk(raw.reshape(nq, nprobe * lmax), k)
    lids = probe_ids.long().gather(1, sel // lmax)
    pos = row_pos[lids, sel % lmax]
    return best, torch.where(torch.isneginf(best), -1, pos)


# --- the table form ----------------------------------------------------------

def pq_lut_reference(xq, codebooks, codec):
    """Plain version of the table launch: (nq, M, ksub) fp32, PQ
    lut[q, s, j] = ⟨q over subspace s, cb[s][j]⟩, RQ ⟨q, cb[s][j]⟩."""
    m, _, w = codebooks.shape
    with full_fp32():
        if codec == "rq":
            return torch.einsum("qd,sjd->qsj", xq, codebooks)
        return torch.einsum("qsd,sjd->qsj", xq.reshape(-1, m, w), codebooks)


def codebook_norms(codebooks):
    """(M,) fp32: each stage's largest squared entry norm (the table launch
    writes it a tile of 64 entries at a time, for the merge's bound)."""
    return (codebooks * codebooks).sum(-1).amax(1)


def residual_bound(cbn, codec):
    """ρ of the CUDA source note from ``codebook_norms``: a bound on ‖res‖
    (PQ: sqrt(Σ_s max_j ‖cb_s[j]‖²); RQ: Σ_s max_j ‖cb_s[j]‖)."""
    return cbn.sqrt().sum() if codec == "rq" else cbn.sum().sqrt()


def error_bound(qn, cn, rho, d: int, m: int, metric: str):
    """E of the CUDA source note: a bound on |table score − plain fp32
    score| of any row probed by a query of squared norm ``qn`` whose probed
    centroids have squared norms at most ``cn`` (the kernel's
    ``error_bound``)."""
    qa, ca = qn ** 0.5, cn ** 0.5
    if metric == "L2":
        return (4 * d + 2 * m + 16) * _U * (qa + ca + rho) ** 2 * 1.001
    return (2 * d + 2 * m + 8) * _U * qa * (ca + rho) * 1.001


def pq_row_terms(lists, counts, centroids, codebooks, codec):
    """(nlist, lmax) fp32 row terms ‖res‖² + 2⟨c_l, res⟩ of every live slot,
    zero past the count: the per-row part of the L2 table form.  Built on
    the lists' device in chunks of lists whose decoded rows stay under
    2^24 floats; it has no kernel (it is built once per layout)."""
    nlist, lmax, m = lists.shape
    d = centroids.shape[1]
    out = torch.zeros((nlist, lmax), dtype=torch.float32, device=lists.device)
    lane = torch.arange(lmax, device=lists.device)
    lc = max(1, (1 << 24) // max(lmax * d, 1))
    for l0 in range(0, nlist, lc):
        codes = lists[l0:l0 + lc]
        n = codes.shape[0]
        res = codec_decode(codes.reshape(-1, m), codebooks,
                           codec).reshape(n, lmax, d)
        c = centroids[l0:l0 + n, None, :]
        rt = (res * res).sum(-1) + 2 * (c * res).sum(-1)
        out[l0:l0 + n] = torch.where(lane < counts[l0:l0 + n, None], rt, 0.0)
    return out


def table_scores_reference(lists, counts, probe_ids, xq, centroids, lut,
                           row_terms, mask, metric):
    """Plain version of the partial launch's scores, (nq, nprobe, lmax)
    fp32 (-inf past the count or where the mask is 0): base in difference
    form plus the row term minus twice the table sum (L2), or base plus the
    table sum (inner product), the table sum taken in stage order."""
    nlist, lmax, m = lists.shape
    nq, nprobe = probe_ids.shape
    ksub = lut.shape[2]
    pids = probe_ids.long()
    c = centroids[pids]                                   # (nq, np, d)
    q = xq[:, None, :]
    base = ((q - c) ** 2).sum(-1) if metric == "L2" else (q * c).sum(-1)
    codes = (gather_lists(lists, pids).long() & (ksub - 1)).reshape(
        nq, nprobe * lmax, m)
    acc = torch.zeros((nq, nprobe * lmax), dtype=torch.float32,
                      device=lists.device)
    for s in range(m):
        acc = acc + lut[:, s, :].gather(1, codes[:, :, s])
    acc = acc.reshape(nq, nprobe, lmax)
    if metric == "L2":
        score = -((base[:, :, None] + row_terms[pids]) - 2 * acc)
    else:
        score = base[:, :, None] + acc
    valid = torch.arange(lmax, device=lists.device) < counts[pids][:, :, None]
    if mask is not None:
        valid = valid & (mask[pids] != 0)
    return torch.where(valid, score, _NEG_INF)


def plan(nq: int, nprobe: int, k: int, m: int, ksub: int, n_sm: int) -> dict:
    """Launch shape: candidates a list (k2 = k + m) and a warp's slots;
    probe splits, probed lists a split (pps) and warps of the partial
    launch, whether its table is staged in shared memory; the merge
    launch's slots and warps a block."""
    k2 = k + margin(k)
    slots = next_pow2(k2 + 32)
    splits = max(1, min(nprobe, -(-_BLOCKS_PER_SM * n_sm // max(nq, 1))))
    pps = min(-(-nprobe // splits), _PPS_MAX)
    splits = -(-nprobe // pps)
    smem_lut = 4 * m * ksub <= _LUT_SMEM_MAX
    fixed = (4 * m * ksub if smem_lut else 0) + 16 * pps
    warps = max(1, min(_MAX_WARPS, (_SMEM_MAX - fixed) // (8 * slots)))
    merge_slots = next_pow2(k2 + max(k2, 32))
    return {"k2": k2, "slots": slots, "splits": splits, "pps": pps,
            "warps": warps, "smem_lut": smem_lut,
            "merge_slots": merge_slots,
            "merge_warps": max(1, min(8, _MERGE_SMEM // (8 * merge_slots)))}


def walk(lists, counts, row_pos, codebooks, centroids, probe_ids, xq, mask,
         *, k, metric, codec, row_terms, n_sm):
    """Plain walk of the three launches on ``plan``'s shapes: table scores;
    each (split, warp)'s best k2 rows by (table score desc, flat index asc)
    over the 32-row chunks the kernel hands it (chunk g of a split's lists
    to warp g % warps); the merge of those lists (the kernels merge a
    block's warps first, then the splits: the same k2); the exact rescore
    of the k2 (``ivf_pq_scan_reference``'s scores); the sort and the
    resolve.
    Returns (scores (nq, k), positions (nq, k), unproven queries)."""
    nlist, lmax, m = lists.shape
    nq, nprobe = probe_ids.shape
    d = xq.shape[1]
    dev = lists.device
    p = plan(nq, nprobe, k, m, codebooks.shape[1], n_sm)
    k2, pps, warps = p["k2"], p["pps"], p["warps"]
    lut = pq_lut_reference(xq, codebooks, codec)
    table = table_scores_reference(lists, counts, probe_ids, xq, centroids,
                                   lut, row_terms, mask,
                                   metric).reshape(nq, -1)
    exact = ivf_pq_scan_reference(lists, counts, probe_ids, xq, centroids,
                                  codebooks, mask, metric,
                                  codec).reshape(nq, -1)
    pids = probe_ids.long()
    live = (pids >= 0) & (pids < nlist)
    cnt = torch.where(live, counts[pids.clamp(0, nlist - 1)].long().clamp(
        0, lmax), 0)
    nch = (cnt + 31) // 32
    split = torch.arange(nprobe, device=dev) // pps
    before = nch.cumsum(1) - nch                 # chunks before each list
    before = before - before[:, split * pps]     # ... within its split
    chunk = torch.arange(lmax, device=dev) // 32
    part = (split[None, :, None] * warps
            + (before[:, :, None] + chunk[None, None, :]) % warps)
    part = part.reshape(nq, -1)
    flat = torch.arange(nprobe * lmax, device=dev).expand(nq, -1)
    valid = table > _NEG_INF
    cand_s, cand_p = [], []
    for prt in range(p["splits"] * warps):
        member = valid & (part == prt)
        s, f = topk_ordered(torch.where(member, table, _NEG_INF),
                            torch.where(member, flat, -1), k2)
        cand_s.append(s)
        cand_p.append(f)
    ms, mp = topk_ordered(torch.cat(cand_s, 1), torch.cat(cand_p, 1), k2)
    full = (mp[:, k2 - 1] >= 0 if mp.shape[1] >= k2
            else torch.zeros(nq, dtype=torch.bool, device=dev))
    a_last = ms[:, -1]
    es = torch.where(mp >= 0, exact.gather(1, mp.clamp(min=0)), _NEG_INF)
    es, ep = topk_ordered(es, mp, k)
    missing = (ep < 0) | torch.isneginf(es)
    slot, r = ep.clamp(min=0) // lmax, ep.clamp(min=0) % lmax
    pos = row_pos[pids.gather(1, slot).clamp(0, nlist - 1), r]
    scores = torch.where(missing, _NEG_INF, es)
    pos = torch.where(missing, -1, pos).to(torch.int32)
    if scores.shape[1] < k:
        pad = k - scores.shape[1]
        scores = torch.cat([scores, scores.new_full((nq, pad), _NEG_INF)], 1)
        pos = torch.cat([pos, pos.new_full((nq, pad), -1)], 1)
    cn = torch.where(live, (centroids * centroids).sum(1)[
        pids.clamp(0, nlist - 1)], 0.0).amax(1)
    rho = residual_bound(codebook_norms(codebooks), codec)
    e = error_bound((xq * xq).sum(1), cn, rho, d, m, metric)
    e_k = scores[:, k - 1]
    unproven = int((full & (e_k > _NEG_INF) & (a_last >= e_k - 2 * e)).sum())
    return scores, pos, unproven


# --- the kernels' wrapper ------------------------------------------------------

def unproven(dev) -> int:
    """Queries counted unproven on ``dev`` since the last reset (reads the
    card: a synchronisation)."""
    return _UNPROVEN.read(dev)


def reset_unproven(dev) -> None:
    _UNPROVEN.reset(dev)


def _check(lists, counts, row_pos, codebooks, centroids, probe_ids, xq,
           mask, k, metric, codec, row_terms):
    """Raise unless the kernels take these inputs."""
    fn = "ivf_pq_list_search"
    dev = lists.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: every tensor must be on the same CUDA "
                         f"device")
    expect(fn, "lists", lists, (torch.uint8,), (None, None, None), dev)
    nlist, lmax, m = lists.shape
    expect(fn, "counts", counts, (torch.int32,), (nlist,), dev)
    expect(fn, "row_pos", row_pos, (torch.int32,), (nlist, lmax), dev)
    expect(fn, "probe_ids", probe_ids, (torch.int32,), (None, None), dev)
    nq, nprobe = probe_ids.shape
    expect(fn, "xq", xq, (torch.float32,), (nq, None), dev)
    d = xq.shape[1]
    expect(fn, "centroids", centroids, (torch.float32,), (nlist, d), dev)
    if codec not in CODECS:
        raise ValueError(f"{fn}: unsupported codec {codec}")
    width = None if codec == "pq" else d
    expect(fn, "codebooks", codebooks, (torch.float32,), (m, None, width),
           dev)
    ksub, dsub = codebooks.shape[1], codebooks.shape[2]
    if codec == "pq" and m * dsub != d:
        raise ValueError(f"{fn}: {m} subquantizers of {dsub} dims do not "
                         f"make d = {d}")
    if ksub < 1 or ksub > 256 or ksub & (ksub - 1):
        raise ValueError(f"{fn}: ksub {ksub} is not a power of two <= 256")
    if mask is not None:
        expect(fn, "mask", mask, (torch.int8, torch.uint8, torch.bool),
               (nlist, lmax), dev)
    if metric not in METRICS:
        raise ValueError(f"{fn}: unsupported metric {metric}")
    if metric == "L2":
        if row_terms is None:
            raise ValueError(f"{fn}: L2 needs the row terms (pq_row_terms)")
        expect(fn, "row_terms", row_terms, (torch.float32,), (nlist, lmax),
               dev)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{fn}: k = {k} outside [1, {MAX_K}]")
    if nprobe < 1 or nprobe * lmax + 32 >= 2 ** 31:
        raise ValueError(f"{fn}: {nprobe} probes x {lmax} slots do not fit "
                         f"int32 flat indices")


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


#: stages of a ``Launch`` (bits of ``Launch.run``'s argument)
TABLE, PARTIAL, MERGE = 1, 2, 4


class Launch:
    """One ``ivf_pq_list_search`` call on the card, checked and planned: its
    outputs (``scores``, ``positions``) and one workspace holding the
    distance table (``lut``), each entry tile's largest squared norm, the
    splits' candidate lists and their largest |c|².
    ``run(stages)`` launches the named stages on the current stream (all
    three by default; the stages alone time the pipeline)."""

    def __init__(self, lists, counts, row_pos, codebooks, centroids,
                 probe_ids, xq, mask, *, k, metric, codec, row_terms):
        _check(lists, counts, row_pos, codebooks, centroids, probe_ids, xq,
               mask, k, metric, codec, row_terms)
        nlist, lmax, m = lists.shape
        nq, nprobe = probe_ids.shape
        ksub = codebooks.shape[1]
        dev = lists.device
        self.plan = p = plan(nq, nprobe, k, m, ksub, _sm_count(dev))
        # Workspace: the table, the entry tiles' norms, the candidate lists
        # (scores, positions) and their |c|² maxima, each 16-byte aligned.
        sizes = (nq * m * ksub, m * -(-ksub // 64), nq * p["splits"] * p["k2"],
                 nq * p["splits"] * p["k2"], nq * p["splits"])
        offsets, at = [], 0
        for n in sizes:
            offsets.append(at)
            at += -(-n // 4) * 4
        self._ws = torch.empty(at, dtype=torch.float32, device=dev)
        ws = [self._ws.data_ptr() + 4 * o for o in offsets]
        self._lut_shape = (nq, m, ksub)
        self.scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
        self.positions = torch.empty((nq, k), dtype=torch.int32, device=dev)
        d = xq.shape[1]
        vec = next(v for v in (16, 8, 4, 1)
                   if m % v == 0 and lists.data_ptr() % v == 0)
        vec4 = (d % 4 == 0 and xq.data_ptr() % 16 == 0
                and centroids.data_ptr() % 16 == 0)
        l2 = metric == "L2"
        self._dev = dev
        self._args = (
            lists.data_ptr(), counts.data_ptr(),
            row_terms.data_ptr() if l2 else None, row_pos.data_ptr(),
            probe_ids.data_ptr(), xq.data_ptr(), centroids.data_ptr(),
            codebooks.data_ptr(), mask.data_ptr() if mask is not None else None,
            nq, nprobe, nlist, lmax, m, d, ksub, codebooks.shape[2], k,
            int(codec == "rq"), int(l2), int(p["smem_lut"]), vec, int(vec4),
            p["splits"], p["pps"], p["warps"], p["k2"], p["slots"],
            p["merge_slots"], p["merge_warps"], *ws, self.scores.data_ptr(),
            self.positions.data_ptr(), _UNPROVEN.tensor(dev).data_ptr())
        # The tensors behind the pointers live as long as this launch.
        self._keep = (lists, counts, row_terms, row_pos, probe_ids, xq,
                      centroids, codebooks, mask)

    @property
    def lut(self) -> torch.Tensor:
        """The distance table the first stage writes, (nq, M, ksub)."""
        n = self._lut_shape[0] * self._lut_shape[1] * self._lut_shape[2]
        return self._ws[:n].view(self._lut_shape)

    def run(self, stages: int = TABLE | PARTIAL | MERGE) -> None:
        from ..utils.kernels import load_library

        with torch.cuda.device(self._dev):
            err = load_library().dfx_ivf_pq_topk(
                *self._args, stages,
                torch.cuda.current_stream(self._dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ivf_pq_list_search: CUDA launch failed "
                               f"with error {err}")


def ivf_pq_list_search(lists, counts, row_pos, codebooks, centroids,
                       probe_ids, xq, mask, *, k, metric, codec,
                       row_terms=None):
    """``pallas_ivf_pq_search``'s contract: (scores (nq, k) max-oriented
    with -inf missing, positions (nq, k) int32 storage rows, -1 missing);
    equal scores to the lower flat index (probe slot · lmax + slot).  On
    CUDA tensors the three launches of the module docstring, which need
    ``row_terms`` (``pq_row_terms``) for L2 and 1 <= k <= MAX_K; on CPU
    tensors ``ivf_pq_list_search_reference``."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (lists, counts, probe_ids, xq,
                                            centroids, codebooks)):
        return ivf_pq_list_search_reference(
            lists, counts, row_pos, codebooks, centroids, probe_ids, xq,
            mask, k=k, metric=metric, codec=codec)
    launch = Launch(lists, counts, row_pos, codebooks, centroids, probe_ids,
                    xq, mask, k=k, metric=metric, codec=codec,
                    row_terms=row_terms)
    if probe_ids.shape[0] > 0:
        launch.run()
        LAUNCHES += 1
    return launch.scores, launch.positions
