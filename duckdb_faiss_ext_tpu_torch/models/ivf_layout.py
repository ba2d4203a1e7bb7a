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
Selector masks are built on the host from ``selector.contains(ids)``
through each layout's row positions.  The TPU-only limits of the JAX
package (the SMEM probe-table blocking, the VMEM gate of the pair tiles)
have no counterpart here.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops.ivf_pq_scan import pq_row_terms
from ..ops.sq import FLOAT_CODECS, sq_row_norms, sq_row_sums
from ..ops.sq_spill import spill_offsets
from ..utils.config import (config, next_capacity, next_pow2, pad_rows,
                            sq_int8_active)

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
    row_pos_host: np.ndarray   # host copy of row_pos (selector masks)
    rn: torch.Tensor | None = None   # SQ: (nlist, lmax) fp32 Σ(scale·c)²
    rs: torch.Tensor | None = None   # SQ: (nlist, lmax) fp32 Σc
    codebooks: torch.Tensor | None = None   # PQ / RQ codebooks
    rt: torch.Tensor | None = None   # PQ / RQ under L2: (nlist, lmax) fp32
    #                                  ‖res‖² + 2⟨c, res⟩, 0 past the count


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

    def _invalidate(self) -> None:
        self._version += 1
        self._counts_cache = None
        self._plan_cache = None
        self._layout: ListLayout | None = None
        self._spill: Spill | None = None
        self._sorted: SortedLayout | None = None
        self._sorted_extras = None
        self._sq_extras = None
        self._list_meta_cache = None
        self._ids_sorted = None
        self._mask_cache: dict = {}

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
                         region scanned densely and merged;
        ("device", L)  — device-resident lists of length L, the only
                         serving path of such an index."""
        if self._dr is not None:
            return ("device", self._dr.lmax)
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
        full = choose_lmax(int(counts.max()) if self.ntotal else 1)
        budget = self.LAYOUT_BUDGET_BYTES
        if self.nlist * full * width <= budget:
            plan = ("full", None)
        else:
            budget_lmax = budget // max(self.nlist * width, 1)
            lmax = 128
            while lmax * 2 <= budget_lmax:
                lmax *= 2
            nspill = int(np.maximum(counts - lmax, 0).sum())
            plan = (("spill", lmax)
                    if budget_lmax >= 128
                    and nspill <= self.SPILL_FRACTION_MAX * self.ntotal
                    else None)
        self._plan_cache = (plan,)
        return plan

    def _build_list_layout(self, lmax_cap: int | None = None):
        """Host-side padded list layout: (payload (nlist, lmax, w) of the
        stored rows (fp32 vectors, SQ or PQ / RQ codes), counts (nlist,), row_pos
        (nlist, lmax), spill).  With ``lmax_cap``, lists longer than the cap
        keep their first cap members; the overflow rows come back in
        ``spill`` = (payload (s, w), assign (s,), pos (s,) storage rows),
        else spill is None."""
        n = self.ntotal
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

    def _build_device_layout(self) -> ListLayout:
        """The padded layout (and spill region) on the device, built once
        per mutation."""
        if self._layout is not None:
            return self._layout
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
        n = self.ntotal
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
        search holds one dispatch tuple per batch)."""
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
            hit = self._mask_cache[key] = build()
        return hit

    def _layout_mask(self, selector) -> torch.Tensor:
        """(nlist, lmax) int8 mask over the padded layout (``_pallas_mask``
        in the JAX package), from the host row positions."""
        def build():
            rp = self._build_device_layout().row_pos_host
            passing = selector.contains(self._ids)
            mask = np.zeros(rp.shape, np.int8)
            valid = rp >= 0
            mask[valid] = passing[rp[valid]]
            return torch.from_numpy(mask).to(self.device)

        return self._cached_mask(("layout", selector.cache_key()), build)

    def _spill_mask(self, selector) -> torch.Tensor:
        """(s_pad,) bool mask over the spill rows."""
        def build():
            sp_pos = self._spill.pos_host
            passing = selector.contains(self._ids)
            mask = np.zeros(sp_pos.shape, bool)
            valid = sp_pos >= 0
            mask[valid] = passing[sp_pos[valid]]
            return torch.from_numpy(mask).to(self.device)

        return self._cached_mask(("spill", selector.cache_key()), build)

    def _selector_mask(self, selector, order) -> torch.Tensor:
        """(cap,) bool mask over the sorted layout's rows."""
        def build():
            rows = selector.contains(self._ids[order])
            cap = self._sorted.xb.shape[0]
            return torch.from_numpy(pad_rows(rows, cap, fill=False)).to(
                self.device)

        return self._cached_mask(("sorted", selector.cache_key()), build)
