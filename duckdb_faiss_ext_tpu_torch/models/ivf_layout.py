"""IVF storage layouts and device builds.

The counterpart of ``duckdb_faiss_ext_tpu/models/ivf_layout.py`` for Flat,
SQ8 / SQ4 / SQ6 and PQ / RQ storage: everything that turns the host state
(vectors or codes, ids, assignments) into the layouts the scans read, and
the selector masks aligned with each.

* The padded list layout: (nlist, lmax, d) fp32 rows, (nlist, lmax, w)
  uint8 packed SQ codes with each slot's Σ(scale·c)² (``rn``) and Σc
  (``rs``) in (nlist, lmax) fp32, or (nlist, lmax, m) uint8 PQ / RQ codes
  with the trained codebooks beside them (and, under L2, each slot's row
  term ‖res‖² + 2⟨c, res⟩ in (nlist, lmax) fp32, built on the device from
  the uploaded codes, ``rt``), with lmax from ``choose_lmax``
  (the JAX package's rule, so both packages build the same layout from the
  same data), read by the list-scan kernels (K6 / K7; K2 / K3 for SQ; K8
  for PQ / RQ).  The plan counts the bytes a row takes (d·4, the SQ code
  width, or m).  When the layout would exceed ``LAYOUT_BUDGET_BYTES`` the
  lists are capped and the overflow rows go to a dense spill region (at
  most ``SPILL_FRACTION_MAX`` of the rows; for SQ with its rows' rn / rs,
  scanned by K5; PQ / RQ codes decoded with their list's centroid), else
  there is no layout plan.  SQ indexes have a plan only while the int8
  path is active (``utils.config.sq_int8_active``), and the float codecs
  (SQfp16 / SQbf16) never, as in the JAX package; PQ / RQ in both
  precision modes.  sq6 stays in packed rows: the JAX
  package's plane-major (nlist, 3·lmax, ceil(d/4)) fold was a Mosaic tiling
  workaround.
* The unpadded layout (Flat storage, the plan ``("unpadded", None)``):
  the fp32 rows stay in storage order, on the card once, and the lists are
  an index over them: ``row_pos`` (n,) int32 holds each list's storage
  rows in list order (a stable sort of the assignments on the device),
  ``offsets`` (nlist + 1,) where each list starts; no padding, no spill.
  The fused K6 reads it in place (ops/ivf_list_scan.py).  A Flat index
  takes it where the padded layout would pass ``LAYOUT_BUDGET_BYTES`` (and
  so be capped and spill): lists are uneven by nature, and at the
  reference's own deployment (IVF2048 over 8.8M x 1536) the longest is six
  times the mean, so padding would take 328 GB for 54 GB of rows.  Its own
  check is against the card's memory (``UNPADDED_MEMORY_SHARE``); an index
  whose rows do not fit raises.  A device-resident Flat index ingests
  straight into it (models/ivf_device.py).  A filtered search reads the
  same kind of index over the slots the selector passes (``pass_index``,
  built once per selector and version), so K6 reads no row the filter
  drops.
* The sorted+gather layout: rows (or codes) sorted by list in one buffer,
  for the elementwise metrics, the SQ decode path and searches without a
  layout plan; for the int8 SQ gather scan, the sorted rows' rn / rs
  beside it; for PQ / RQ the codebooks.  The JAX package also kept the
  sorted rows' list assignments for PQ; its gather scan adds the probed
  list's centroid instead, so they are not kept here.

Layouts are built on the host in numpy, as in the JAX package, uploaded
to the index's device once per mutation, and cached until the next one.
A device-resident index (models/ivf_device.py) already holds its padded
layout on the card: its plan is ``("device", lmax)`` whatever the metric
or precision mode, and the layout is its resident tensors.
The padded layout's and the spill's selector masks are built on the
device from their row positions (``ops.selectors.device_row_mask``; the
host row positions serve only the plain version, ``host_row_mask``); the
sorted layout's mask is built on the host from ``selector.contains``.  The TPU-only limits of the JAX
package (the SMEM probe-table blocking, the VMEM gate of the pair tiles)
have no counterpart here.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import errors
from ..ops.ivf_pq_scan import pq_row_terms
from ..ops.selectors import device_row_mask, labels_for_device_mask
from ..ops.sq import FLOAT_CODECS, sq_row_norms, sq_row_sums
from ..ops.sq_spill import spill_offsets
from ..utils.config import (config, next_capacity, next_pow2, pad_rows,
                            sq_int8_active)
from ..utils.profiling import build_span

def choose_lmax(counts_max: int) -> int:
    """Pad list length: ≥ 128 slots, powers of two up to 512, then the
    next multiple of 512 (``duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
    choose_lmax``, kept as it is)."""
    if counts_max <= 512:
        lmax = 128
        while lmax < counts_max:
            lmax *= 2
        return lmax
    return 512 * -(-counts_max // 512)


class ListLayout(NamedTuple):
    """The padded list layout on the device."""
    payload: torch.Tensor      # (nlist, lmax, d) fp32 / (nlist, lmax, w) u8
    #                            SQ or PQ / RQ codes
    counts: torch.Tensor       # (nlist,) int32 rows kept per list
    row_pos: torch.Tensor      # (nlist, lmax) int32 storage row, -1 padding
    centroids: torch.Tensor    # (nlist, d) fp32
    row_pos_host: np.ndarray   # host copy of row_pos (host_row_mask)
    rn: torch.Tensor | None = None   # SQ: (nlist, lmax) fp32 Σ(scale·c)²
    rs: torch.Tensor | None = None   # SQ: (nlist, lmax) fp32 Σc
    codebooks: torch.Tensor | None = None   # PQ / RQ codebooks
    rt: torch.Tensor | None = None   # PQ / RQ under L2: (nlist, lmax) fp32
    #                                  ‖res‖² + 2⟨c, res⟩, 0 past the count

    @property
    def lmax(self) -> int:
        """Slots a list."""
        return self.payload.shape[1]


class Spill(NamedTuple):
    """Overflow rows of capped lists, padded to s_pad rows."""
    payload: torch.Tensor      # (s_pad, d) fp32 / (s_pad, w) uint8 codes
    assign: torch.Tensor       # (s_pad,) int32 list of each row
    pos: torch.Tensor          # (s_pad,) int32 storage row, -1 padding
    pos_host: np.ndarray
    n: int                     # real rows
    rn: torch.Tensor | None = None   # SQ: (s_pad,) fp32 Σ(scale·c)²
    rs: torch.Tensor | None = None   # SQ: (s_pad,) fp32 Σc
    #: (nlist + 1,) int64: list l's rows are [offsets[l], offsets[l + 1])
    #: (the rows are sorted by list)
    offsets: torch.Tensor | None = None


class UnpaddedLayout(NamedTuple):
    """Flat rows in storage order and the lists as an index over them:
    list l's j-th row is ``payload[row_pos[offsets[l] + j]]``."""
    payload: torch.Tensor      # (cap, d) fp32 rows in storage order, cap ≥ n
    counts: torch.Tensor       # (nlist,) int32 rows a list
    offsets: torch.Tensor      # (nlist + 1,) int32 each list's first slot
    row_pos: torch.Tensor      # (n,) int32 storage row of each slot
    centroids: torch.Tensor    # (nlist, d) fp32
    lmax: int                  # the longest list


def list_index(assign: torch.Tensor, nlist: int):
    """(counts (nlist,), offsets (nlist + 1,), row_pos (n,)) int32 of the
    lists ``assign`` (n,) on its device: each list's rows in storage order,
    by a stable sort of the assignments."""
    row_pos = torch.sort(assign.long(), stable=True).indices.to(torch.int32)
    counts = torch.bincount(assign.long(), minlength=nlist)
    offsets = torch.zeros(nlist + 1, dtype=torch.int64, device=assign.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return counts.to(torch.int32), offsets.to(torch.int32), row_pos


def pass_index(lay: UnpaddedLayout, mask: torch.Tensor) -> UnpaddedLayout:
    """The unpadded layout restricted to the slots whose ``mask`` byte (n,)
    is not 0: each list's passing slots in slot order (``row_pos``), their
    ``counts`` and ``offsets``, and ``lmax`` the longest passing list (at
    least 1); the payload and centroids are shared.  A list's j-th passing
    row keeps its place among the list's passing rows, so K6 scores the
    same rows in the same order as over the full layout with the mask."""
    keep = mask != 0
    before = torch.zeros(keep.shape[0] + 1, dtype=torch.int64,
                         device=keep.device)
    torch.cumsum(keep, 0, out=before[1:])
    offsets = before[lay.offsets.long()]
    counts = offsets.diff()
    lmax = max(1, int(counts.max()) if counts.numel() else 1)
    return lay._replace(counts=counts.to(torch.int32),
                        offsets=offsets.to(torch.int32),
                        row_pos=lay.row_pos[keep], lmax=lmax)


def device_memory_bytes(device: torch.device) -> int | None:
    """A CUDA device's memory in bytes; None for any other device (no
    limit is checked there)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


class SortedLayout(NamedTuple):
    """Rows sorted by list: each list a contiguous block."""
    xb: torch.Tensor           # (cap, d) fp32 / (cap, w) uint8 codes
    lmax: int                  # scan window: pow2 ≥ the longest list
    centroids: torch.Tensor
    order: np.ndarray          # sorted row → storage row
    codebooks: torch.Tensor | None = None   # PQ / RQ codebooks


class IVFLayout:
    """Layout methods of ``models.ivf.IVFIndex``."""

    #: Device-memory budget of the padded (nlist, lmax, d) layout on the
    #: 80 GB H100: half the card, leaving the other half for the search
    #: temporaries (query blocks of IVFServe.SCAN_BLOCK_BYTES and their
    #: top-k keys) and for other indexes.  A class attribute, so a test can
    #: set it small.
    LAYOUT_BUDGET_BYTES = 40 << 30
    #: spill-region cap: beyond this fraction of rows overflowing the
    #: capped layout, the dense spill scan would dominate and the
    #: sorted+gather layout is used instead.
    SPILL_FRACTION_MAX = 0.2
    #: share of the card's memory that an unpadded layout's rows may take;
    #: the rest holds the search's temporaries, the per-list index and a
    #: selector's pass index (a class attribute, so a test can set it)
    UNPADDED_MEMORY_SHARE = 0.9
    #: whether a Flat index over budget takes the unpadded layout (IMIIndex
    #: keeps the capped layout and its spill; a class attribute, so a test
    #: can hold an IVF index to the capped layout)
    UNPADDED_FLAT = True

    def _invalidate(self) -> None:
        self._version += 1
        self._counts_cache = None
        self._plan_cache = None
        self._layout: ListLayout | None = None
        self._unpadded: UnpaddedLayout | None = None
        self._spill: Spill | None = None
        self._sorted: SortedLayout | None = None
        self._sorted_extras = None
        self._sq_extras = None
        self._list_meta_cache = None
        self._ids_sorted = None
        self._mask_cache: dict = {}
        self._mask_labels_cache: dict = {}
        self._sharded_cache = None

    def _counts(self) -> np.ndarray:
        if self._counts_cache is None:
            self._counts_cache = np.bincount(self._assign,
                                             minlength=self.nlist)
        return self._counts_cache

    def _layout_plan(self):
        """Layout plan for the list-scan kernels (``_pallas_plan`` in the
        JAX package):
        None           — no padded layout (elementwise metric, SQ without
                         the int8 path, or the spill would exceed
                         SPILL_FRACTION_MAX);
        ("full", None) — the padded (nlist, lmax, w) layout fits the budget;
        ("spill", L)   — lists capped at L, overflow rows in a spill
                         region scanned densely and merged (SQ, PQ / RQ,
                         IMI);
        ("unpadded", None) — Flat rows in storage order with a per-list
                         index (``UnpaddedLayout``), where the padded
                         layout would pass the budget;
        ("device", L)  — device-resident lists of length L, the only
                         serving path of such an index (an unpadded
                         device-resident index: ("unpadded", None))."""
        if self._dr is not None:
            return self._dr.plan
        if self.metric.name not in ("L2", "INNER_PRODUCT"):
            return None
        if self.sq_type is not None and (self.sq_type in FLOAT_CODECS
                                         or not sq_int8_active()):
            return None
        if self._plan_cache is not None:
            return self._plan_cache[0]
        width = (self._codes.shape[1] if self._codes is not None
                 else self.d * 4)
        counts = self._counts()
        full = choose_lmax(int(counts.max()) if self._nstored else 1)
        budget = self.LAYOUT_BUDGET_BYTES
        if self.nlist * full * width <= budget:
            plan = ("full", None)
        elif self._codes is None and self.UNPADDED_FLAT:
            self._check_unpadded_fits(self._nstored)
            plan = ("unpadded", None)
        else:
            budget_lmax = budget // max(self.nlist * width, 1)
            lmax = 128
            while lmax * 2 <= budget_lmax:
                lmax *= 2
            nspill = int(np.maximum(counts - lmax, 0).sum())
            plan = (("spill", lmax)
                    if budget_lmax >= 128
                    and nspill <= self.SPILL_FRACTION_MAX * self._nstored
                    else None)
        self._plan_cache = (plan,)
        return plan

    def _check_unpadded_fits(self, rows: int) -> None:
        """Raise unless ``rows`` fp32 rows take at most
        ``UNPADDED_MEMORY_SHARE`` of the card's memory."""
        total = device_memory_bytes(self.device)
        need = rows * self.d * 4
        if total is not None and need > self.UNPADDED_MEMORY_SHARE * total:
            raise errors.InvalidInputError(
                f"the index's {rows} rows of {self.d} fp32 ({need / 1e9:.1f} "
                f"GB) do not fit the card's memory ({total / 1e9:.1f} GB, "
                f"{self.UNPADDED_MEMORY_SHARE:.0%} of it for the rows) in any "
                f"layout; use SQ or PQ storage, or place the index over "
                f"several devices")

    def _build_unpadded_layout(self) -> UnpaddedLayout:
        """The unpadded layout on the device, its per-list index built
        once per mutation."""
        if self._unpadded is not None:
            return self._unpadded
        with build_span("models.layout_build"):
            dev = self.device
            payload = (self._dr.payload if self._dr is not None
                       else torch.from_numpy(self._xb).to(dev))
            counts, offsets, row_pos = list_index(
                torch.from_numpy(self._assign).to(dev), self.nlist)
            lmax = max(1, int(self._counts().max()) if self._nstored else 1)
            self._unpadded = UnpaddedLayout(
                payload, counts, offsets, row_pos,
                torch.from_numpy(self._centroids).to(dev), lmax)
        return self._unpadded

    def _build_list_layout(self, lmax_cap: int | None = None):
        """Host-side padded list layout: (payload (nlist, lmax, w) of the
        stored rows (fp32 vectors, SQ or PQ / RQ codes), counts (nlist,), row_pos
        (nlist, lmax), spill).  With ``lmax_cap``, lists longer than the cap
        keep their first cap members; the overflow rows come back in
        ``spill`` = (payload (s, w), assign (s,), pos (s,) storage rows),
        else spill is None."""
        n = self._nstored
        counts = self._counts()
        if lmax_cap is None and n and \
                counts.max() > max(32 * n / self.nlist, 4096):
            print(f"duckdb_faiss_ext_tpu_torch: IVF list skew is extreme "
                  f"(max {counts.max()} vs avg {n / self.nlist:.0f}); the "
                  f"padded layout will be memory-heavy — consider retraining "
                  f"(kmeans_balance) or fewer lists", file=sys.stderr)
        lmax = choose_lmax(max(1, int(counts.max()) if n else 1))
        if lmax_cap is not None:
            lmax = min(lmax, lmax_cap)
        kept = np.minimum(counts, lmax)
        row_pos = np.full((self.nlist, lmax), -1, np.int32)
        raw = self._codes if self._codes is not None else self._xb
        w = raw.shape[1]
        payload = np.zeros((self.nlist, lmax, w), raw.dtype)
        spill = None
        if n:
            # Rank of each row within its list decides slot vs spill.
            order = np.argsort(self._assign, kind="stable")
            offsets = np.concatenate([[0], np.cumsum(counts)])
            sorted_assign = self._assign[order]
            ranks = np.arange(n, dtype=np.int64) - offsets[sorted_assign]
            keep = ranks < lmax
            flat = sorted_assign[keep].astype(np.int64) * lmax + ranks[keep]
            payload.reshape(-1, w)[flat] = raw[order[keep]]
            row_pos.reshape(-1)[flat] = order[keep]
            if not keep.all():
                sp = order[~keep]
                spill = (raw[sp], self._assign[sp], sp.astype(np.int32))
        return payload, kept.astype(np.int32), row_pos, spill

    def _build_device_layout(self) -> ListLayout | UnpaddedLayout:
        """The padded layout (and spill region) on the device, built once
        per mutation; the unpadded layout where that is the plan."""
        plan = self._layout_plan()
        if plan is not None and plan[0] == "unpadded":
            return self._build_unpadded_layout()
        if self._layout is not None:
            return self._layout
        with build_span("models.layout_build"):
            return self._upload_layout()

    def _upload_layout(self) -> ListLayout:
        """Build the padded layout and put it on the device."""
        if self._dr is not None:
            self._layout, self._spill = self._device_layout()
            return self._layout
        plan = self._layout_plan()
        lmax_cap = plan[1] if plan is not None else None
        payload, counts, row_pos, spill = self._build_list_layout(lmax_cap)
        dev = self.device

        def up(a):
            return torch.from_numpy(a).to(dev)

        rn = rs = None
        if self.sq_type is not None:
            # Σ(scale·c)² and Σc of every row, scattered through row_pos.
            rn, rs = self._sq_row_extras()
            valid = row_pos >= 0
            lay_rn = np.zeros(row_pos.shape, np.float32)
            lay_rs = np.zeros(row_pos.shape, np.float32)
            lay_rn[valid] = rn[row_pos[valid]]
            lay_rs[valid] = rs[row_pos[valid]]
        lay = ListLayout(
            up(payload), up(counts), up(row_pos), up(self._centroids),
            row_pos, *((up(lay_rn), up(lay_rs)) if rn is not None
                       else (None, None)),
            up(self._pq_codebooks) if self.pq_m is not None else None)
        if self.pq_m is not None and self.metric.name == "L2":
            # K8's L2 table form reads each slot's row term beside its codes.
            lay = lay._replace(rt=pq_row_terms(
                lay.payload, lay.counts, lay.centroids, lay.codebooks,
                self.pq_codec))
        self._layout = lay
        if spill is not None:
            sp_payload, sp_assign, sp_pos = spill
            s_pad = max(128, next_pow2(sp_pos.shape[0]))
            pos_host = pad_rows(sp_pos, s_pad, fill=-1).astype(np.int32)
            extras = ((up(pad_rows(rn[sp_pos], s_pad)),
                       up(pad_rows(rs[sp_pos], s_pad)))
                      if rn is not None else (None, None))
            self._spill = Spill(
                up(pad_rows(sp_payload, s_pad)),
                up(pad_rows(sp_assign, s_pad).astype(np.int32)),
                up(pos_host), pos_host, int(sp_pos.shape[0]), *extras,
                up(spill_offsets(sp_assign, self.nlist)))
        return self._layout

    def _sq_row_extras(self):
        """Per-row (Σ(scale·c)², Σc) fp32 of the stored codes, on the host
        in storage order (the JAX package's ``sq_row_norms`` /
        ``sq_row_sums``), cached per version."""
        if self._sq_extras is None:
            self._sq_extras = (
                sq_row_norms(self._codes, self._sq_scale, self.d,
                             self.sq_type),
                sq_row_sums(self._codes, self.d, self.sq_type))
        return self._sq_extras

    def _build_device(self) -> SortedLayout:
        """The sorted+gather layout on the device."""
        if self._sorted is not None:
            return self._sorted
        with build_span("models.layout_build"):
            return self._upload_sorted()

    def _upload_sorted(self) -> SortedLayout:
        """Build the sorted+gather layout and put it on the device."""
        n = self._nstored
        order = np.argsort(self._assign, kind="stable").astype(np.int64)
        counts = self._counts()
        # Scan window: the longest list, pow2-bucketed.  Padding rows past
        # n are never inside a probed window's valid part.
        lmax = max(128, next_pow2(max(1, int(counts.max()) if n else 1)))
        cap = max(config.min_capacity, next_capacity(n + 1))
        raw = self._codes if self._codes is not None else self._xb
        xb_sorted = pad_rows(raw[order] if n else raw, cap)
        self._sorted = SortedLayout(
            torch.from_numpy(xb_sorted).to(self.device), lmax,
            torch.from_numpy(self._centroids).to(self.device), order,
            torch.from_numpy(self._pq_codebooks).to(self.device)
            if self.pq_m is not None else None)
        return self._sorted

    def _sorted_sq_extras(self):
        """(rn, rs) (cap,) fp32 device tensors of the sorted SQ rows, for
        the int8 gather scan; cached per version."""
        if self._sorted_extras is None:
            sl = self._build_device()
            cap = sl.xb.shape[0]
            rn, rs = self._sq_row_extras()
            self._sorted_extras = tuple(
                torch.from_numpy(pad_rows(a[sl.order], cap)).to(self.device)
                for a in (rn, rs))
        return self._sorted_extras

    def _sorted_list_meta(self):
        """(offsets, counts) int32 device tensors of the sorted layout's
        list blocks, cached per version."""
        if self._list_meta_cache is None:
            c = self._counts().astype(np.int64)
            off = np.concatenate([[0], np.cumsum(c[:-1])])
            self._list_meta_cache = (
                torch.from_numpy(off.astype(np.int32)).to(self.device),
                torch.from_numpy(c.astype(np.int32)).to(self.device))
        return self._list_meta_cache

    def _sorted_ids(self, order) -> np.ndarray:
        """ids in sorted-layout order, cached per layout build (a batched
        search holds one Dispatch per batch)."""
        if self._ids_sorted is None or self._ids_sorted[0] is not order:
            self._ids_sorted = (order, self._ids[order])
        return self._ids_sorted[1]

    def row_labels(self) -> np.ndarray:
        return self._ids

    # --- selector masks ---------------------------------------------------
    def _cached_mask(self, key, build):
        hit = self._mask_cache.get(key)
        if hit is None:
            if len(self._mask_cache) >= 4:
                self._mask_cache.clear()
            with build_span("models.mask_build"):
                hit = self._mask_cache[key] = build()
        return hit

    def _mask_labels(self, device) -> torch.Tensor | None:
        """The ids as the device mask path reads them
        (``labels_for_device_mask``: None where they are the storage
        positions), on ``device``, cached per index version."""
        if device not in self._mask_labels_cache:
            self._mask_labels_cache[device] = labels_for_device_mask(
                self._ids, device)
        return self._mask_labels_cache[device]

    def _row_mask(self, selector, row_pos: torch.Tensor) -> torch.Tensor:
        """int8 pass mask over a layout's row positions, built on their
        device (``device_row_mask``)."""
        return device_row_mask(selector, row_pos,
                               self._mask_labels(row_pos.device))

    def _layout_filter(self, selector) -> torch.Tensor | UnpaddedLayout:
        """What the list search reads for a selector, built on the device
        from the layout's row positions once per selector and version: the
        (nlist, lmax) int8 mask over the padded layout (``_pallas_mask`` in
        the JAX package), or the unpadded layout's passing slots
        (``pass_index``; its (n,) mask is dropped once they are indexed)."""
        def build():
            lay = self._build_device_layout()
            mask = self._row_mask(selector, lay.row_pos)
            if isinstance(lay, UnpaddedLayout):
                return pass_index(lay, mask)
            return mask

        return self._cached_mask(("layout", selector.cache_key()), build)

    def _spill_mask(self, selector) -> torch.Tensor:
        """(s_pad,) bool mask over the spill rows, built on the device."""
        def build():
            sp = self._spill
            return self._row_mask(selector, sp.pos).bool()

        return self._cached_mask(("spill", selector.cache_key()), build)

    def _selector_mask(self, selector, order) -> torch.Tensor:
        """(cap,) bool mask over the sorted layout's rows."""
        def build():
            rows = selector.contains(self._ids[order])
            cap = self._sorted.xb.shape[0]
            return torch.from_numpy(pad_rows(rows, cap, fill=False)).to(
                self.device)

        return self._cached_mask(("sorted", selector.cache_key()), build)
