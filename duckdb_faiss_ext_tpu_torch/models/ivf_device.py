"""Device-resident IVF ingest: the padded list layout built on the card.

The counterpart of ``duckdb_faiss_ext_tpu/models/ivf_device.py``
(``faiss_train_device`` / ``faiss_add_device``).  The host path
(models/ivf.py) keeps every code on the host and builds the padded layout
there once per mutation; here vectors that already live on the card (or
arrays moved there once) are assigned, encoded and scattered into a padded
``(nlist, lmax, w)`` payload preallocated on the card, so the corpus never
crosses to the host and only O(n) integers of bookkeeping (assignments,
slots, ids) do.  This is what lets one card serve the MS MARCO corpus of
the reference's benchmark (8,841,823 x 1536: 54 GB in fp32, 13.6 GB of SQ8
codes) without the host path's adds and layout build.

* Assignment reuses the index's own coarse assignment
  (``IVFIndex._assign_lists`` on card tensors), so a device add and a host
  add put each row in the same list.  With ``assign_topk`` = T > 1 each row
  goes to the nearest of its top-T lists with free capacity
  (``capped_assign``, ScaNN-style balanced partitioning); rows with no
  free candidate keep their nearest list and spill.
* Encoding is ops/sq.py's quantizer and a torch form of its packing, so
  codes are byte-equal to the host path's.  Each row's Σ(scale·c)² (rn) is
  an fp32 sum taken on the card, equal to the host's numpy sum to rounding;
  Σc (rs) is exact.
* Slots follow the host layout's order: a list's running count, then the
  rank within the add, stable.  The first ``lmax`` rows of a list fill its
  slots in place (``index_copy_`` into the payload); later ones go to the
  spill buffer, which grows by doubling.  Given the same trained state and
  ``assign_topk`` 0 the layout (payload, counts, row_pos, rs, spill) is
  byte-equal to the host-built one; the spill is put into the host's order
  (by list, then insertion) when the layout is built.
* Every cached layout is dropped before an add writes into the payload, and
  the spill's shrink to its padded length replaces the buffer only while
  no cached ``Spill`` / ``ListLayout`` holds it (the JAX package deleted a
  buffer a cached tuple still held).

A device-resident index serves through the padded layout only, in both
precision modes (models/ivf_layout.py).  ``state_dict`` gathers the codes
back in insertion order, so a checkpoint has the shared format and loads
as an ordinary host-path index.  Not ported: the JAX package's XLA
compile-shape workarounds (``_pad_idx``'s pow2 index padding,
``_shrink_rows``, the 2048-row spill granularity of its Mosaic spill
kernel) and the plane-major sq6 payload; PQ / RQ storage needs the host
path here too.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..ops.sq import (FLOAT_CODECS, SQ_LEVELS, sq_decode, sq_pack_t,
                      sq_quantize)
from ..ops.sq_spill import spill_offsets
from ..utils.config import full_fp32, next_pow2, pad_rows
from .ivf_layout import ListLayout, Spill, choose_lmax

#: rows a chunk of the device encode and scatter takes
_CHUNK = 1 << 18


class DeviceResidentState:
    """Card tensors and host bookkeeping of a device-resident layout."""

    __slots__ = ("lmax", "payload", "rn", "rs", "row_pos", "counts", "slot",
                 "spill_payload", "spill_rn", "spill_rs", "spill_assign",
                 "spill_pos", "spill_n")

    def __init__(self, nlist: int, lmax: int, width: int, dtype, sq: bool,
                 device: torch.device):
        self.lmax = int(lmax)
        self.payload = torch.zeros((nlist, lmax, width), dtype=dtype,
                                   device=device)
        self.rn = (torch.zeros((nlist, lmax), dtype=torch.float32,
                               device=device) if sq else None)
        self.rs = torch.zeros_like(self.rn) if sq else None
        self.row_pos = np.full((nlist, lmax), -1, np.int32)   # host
        self.counts = np.zeros((nlist,), np.int64)    # rows a list, spill too
        self.slot = np.empty((0,), np.int64)  # a row's slot, or -(spill + 1)
        self.spill_payload = None             # (capacity, width) on the card
        self.spill_rn = self.spill_rs = None  # (capacity,) fp32 (SQ)
        self.spill_assign = np.empty((0,), np.int32)
        self.spill_pos = np.empty((0,), np.int32)
        self.spill_n = 0

    def grow_spill(self, need: int) -> None:
        """Spill capacity for ``need`` rows: a power of two of at least 128
        rows, doubled as it fills; rows past ``spill_n`` stay zero."""
        cap = (self.spill_payload.shape[0]
               if self.spill_payload is not None else 0)
        if need <= cap:
            return
        new_cap = max(128, cap)
        while new_cap < need:
            new_cap *= 2
        n = self.spill_n
        grown = self.payload.new_zeros((new_cap, self.payload.shape[2]))
        if self.spill_payload is not None:
            grown[:n] = self.spill_payload[:n]
        self.spill_payload = grown
        if self.rn is not None:
            for name in ("spill_rn", "spill_rs"):
                buf = self.rn.new_zeros((new_cap,))
                old = getattr(self, name)
                if old is not None:
                    buf[:n] = old[:n]
                setattr(self, name, buf)


def capped_assign(cand: np.ndarray, counts: np.ndarray,
                  cap: int) -> tuple[np.ndarray, int]:
    """Greedy capacity-capped assignment: each row goes to its nearest
    candidate list with free capacity; a row whose every candidate is full
    keeps its nearest list (column 0) and spills.  The JAX package's
    function, in numpy, with identical results.

    cand: (m, T) int32 candidate lists, nearest first; counts: (nlist,)
    running list sizes; cap: the padded lmax.  Returns (assign (m,) int32,
    rows displaced from their nearest list)."""
    m, T = cand.shape
    counts = counts.astype(np.int64).copy()
    assign = np.full((m,), -1, np.int32)
    pending = np.arange(m)
    for t in range(T):
        c = cand[pending, t]
        order = np.argsort(c, kind="stable")
        cs = c[order]
        # rank of each pending row among those wanting the same list
        grp = np.searchsorted(cs, np.arange(counts.shape[0]))
        rank = np.arange(cs.shape[0]) - grp[cs]
        fits = counts[cs] + rank < cap
        taken = pending[order[fits]]
        assign[taken] = cs[fits]
        counts += np.bincount(cs[fits], minlength=counts.shape[0])
        pending = pending[order[~fits]]
        if pending.size == 0:
            break
    displaced = m - pending.size - int((assign[assign >= 0]
                                        == cand[assign >= 0, 0]).sum())
    if pending.size:
        assign[pending] = cand[pending, 0]
    return assign, displaced


class IVFDevice:
    """Device-resident ingest methods of ``models.ivf.IVFIndex``."""

    #: spill capacity beyond its padded length above which the layout build
    #: gives it back to the card (a class attribute, so a test can set it
    #: small)
    SPILL_SLACK_BYTES = 256 << 20

    def _device_ingest_codec(self) -> str | None:
        """The storage codec (None for Flat), or raise with the JAX
        package's texts where device-resident ingest does not apply."""
        if self.pq_m is not None:
            raise errors.InvalidInputError(
                "device-resident ingest supports Flat, SQ8, SQ6 and SQ4 "
                "storage (PQ/RQ encoding needs the host path)")
        if self.sq_type in FLOAT_CODECS:
            raise errors.InvalidInputError(
                f"device-resident ingest supports Flat, SQ8, SQ6 and SQ4 "
                f"storage, not SQ codec {self.sq_type}")
        if self.metric.name not in ("L2", "INNER_PRODUCT"):
            raise errors.InvalidInputError(
                "device-resident ingest supports only L2 and INNER_PRODUCT")
        return self.sq_type

    def _device_rows(self, x, what: str) -> torch.Tensor:
        """x as a (n, d) fp32 tensor on the index's device (a tensor already
        there is used as it is)."""
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x, np.float32))
        x = x.to(device=self.device, dtype=torch.float32)
        if x.dim() != 2 or x.shape[1] != self.d:
            raise errors.InvalidInputError(
                f"{what} must be (n, {self.d}), got {tuple(x.shape)}")
        return x

    def train_device(self, x) -> None:
        """``train`` for rows on the card: the coarse k-means and the SQ
        ranges are fitted there; only the centroid table comes back."""
        if self.is_trained:
            return
        self._device_ingest_codec()
        self._fit(self._device_rows(x, "training data"))

    def add_device(self, x, ids=None, *, expected_total: int | None = None,
                   lmax: int | None = None,
                   spill_capacity: int | None = None) -> None:
        """``add`` / ``add_with_ids`` for rows on the card.  The first call
        fixes the padded list length: ``lmax`` (rounded up by
        ``choose_lmax``), or ``choose_lmax`` of twice the balanced list
        length for ``expected_total`` rows.  ``spill_capacity`` sizes the
        spill buffer up front."""
        self._require_trained()
        codec = self._device_ingest_codec()
        x = self._device_rows(x, "vectors")
        m = x.shape[0]
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + m, dtype=np.int64)
        else:
            ids = np.asarray(ids, dtype=np.int64).reshape(-1)
            if ids.shape[0] != m:
                raise errors.add_error(
                    f"number of ids ({ids.shape[0]}) does not match number "
                    f"of vectors ({m})")
        if m == 0:
            return
        if self._dr is None:
            self._dr = self._new_device_state(codec, expected_total, lmax,
                                              spill_capacity)
        dr = self._dr
        self._invalidate()      # no cached layout holds the payload now

        t = min(int(self.assign_topk or 0), self.nlist)
        if t > 1:
            assign, _ = capped_assign(self._assign_candidates(x, t),
                                      dr.counts, dr.lmax)
        else:
            assign = self._assign_lists(x)

        # Slots as the host layout orders them: running count, then the rank
        # within this add, stable.
        order = np.argsort(assign, kind="stable")
        ch_counts = np.bincount(assign, minlength=self.nlist)
        ch_off = np.concatenate([[0], np.cumsum(ch_counts)])
        ranks = np.empty((m,), np.int64)
        ranks[order] = np.arange(m, dtype=np.int64) - ch_off[assign[order]]
        slot = dr.counts[assign] + ranks
        keep = slot < dr.lmax
        spill_at = dr.spill_n + np.cumsum(~keep) - 1
        n_spill = int((~keep).sum())
        if n_spill:
            dr.grow_spill(dr.spill_n + n_spill)
        flat = assign.astype(np.int64) * dr.lmax + slot
        for i in range(0, m, _CHUNK):
            self._scatter_chunk(x[i:i + _CHUNK], codec, keep[i:i + _CHUNK],
                                flat[i:i + _CHUNK], spill_at[i:i + _CHUNK])

        row_base = self.ntotal
        kidx = np.nonzero(keep)[0]
        dr.row_pos[assign[kidx], slot[kidx]] = (row_base + kidx).astype(
            np.int32)
        slot_rec = np.where(keep, slot, -(spill_at + 1))
        if n_spill:
            sidx = np.nonzero(~keep)[0]
            dr.spill_assign = np.concatenate([dr.spill_assign, assign[sidx]])
            dr.spill_pos = np.concatenate(
                [dr.spill_pos, (row_base + sidx).astype(np.int32)])
            dr.spill_n += n_spill
        dr.counts += ch_counts
        dr.slot = np.concatenate([dr.slot, slot_rec])
        self._ids = np.concatenate([self._ids, ids])
        self._assign = np.concatenate([self._assign, assign])
        self._invalidate()

    def _new_device_state(self, codec, expected_total, lmax,
                          spill_capacity) -> DeviceResidentState:
        if self.ntotal:
            raise errors.InvalidInputError(
                "device-resident ingest cannot be mixed with host-path adds "
                "on the same index")
        if lmax is None:
            if expected_total is None:
                raise errors.InvalidInputError(
                    "the first add_device call must size the padded device "
                    "layout: pass expected_total= (total rows you will add) "
                    "or an explicit lmax=")
            lmax = max(128, int(2 * expected_total / max(self.nlist, 1)))
        dr = DeviceResidentState(
            self.nlist, choose_lmax(int(lmax)),
            self._codes.shape[1] if codec is not None else self.d,
            torch.uint8 if codec is not None else torch.float32,
            codec is not None, self.device)
        if spill_capacity:
            dr.grow_spill(int(spill_capacity))
        return dr

    def _scatter_chunk(self, xc, codec, keep, flat, spill_at) -> None:
        """Encode rows on the card and write them in place: kept rows into
        their payload slots (flat indices ``flat``), the others at their
        spill rows (``spill_at``); keep, flat and spill_at are host
        arrays."""
        dr = self._dr
        dev = self.device
        if codec is not None:
            vmin, scale = self._sq_ranges()
            q = sq_quantize(xc, vmin, scale, SQ_LEVELS[codec])
            rows = sq_pack_t(q, codec)
            qf = q.to(torch.float32)
            rs = qf.sum(1)
            with full_fp32():
                rn = (qf * qf) @ (scale * scale)
            del q, qf
        else:
            rows, rn, rs = xc, None, None
        kidx = torch.from_numpy(np.nonzero(keep)[0]).to(dev)
        if kidx.numel():
            at = torch.from_numpy(flat[keep]).to(dev)
            dr.payload.view(-1, rows.shape[1]).index_copy_(
                0, at, rows.index_select(0, kidx))
            if rn is not None:
                dr.rn.view(-1).index_copy_(0, at, rn.index_select(0, kidx))
                dr.rs.view(-1).index_copy_(0, at, rs.index_select(0, kidx))
        sidx = torch.from_numpy(np.nonzero(~keep)[0]).to(dev)
        if sidx.numel():
            at = torch.from_numpy(spill_at[~keep]).to(dev)
            dr.spill_payload.index_copy_(0, at, rows.index_select(0, sidx))
            if rn is not None:
                dr.spill_rn.index_copy_(0, at, rn.index_select(0, sidx))
                dr.spill_rs.index_copy_(0, at, rs.index_select(0, sidx))

    def _device_layout(self):
        """(ListLayout, Spill or None) over the resident tensors; only the
        counts, row positions and spill bookkeeping are uploaded."""
        dr = self._dr
        dev = self.device

        def up(a):
            return torch.from_numpy(a).to(dev)

        lay = ListLayout(dr.payload,
                         up(np.minimum(dr.counts, dr.lmax).astype(np.int32)),
                         up(dr.row_pos), up(self._centroids), dr.row_pos,
                         dr.rn, dr.rs)
        if not dr.spill_n:
            return lay, None
        self._sort_spill()
        n = dr.spill_n
        s_pad = max(128, next_pow2(n))
        slack = dr.spill_payload.shape[0] - s_pad
        if slack * dr.spill_payload[0].nbytes > self.SPILL_SLACK_BYTES:
            # The layout being built is the only reader of the spill (every
            # cached one was dropped with the last mutation): replace the
            # buffer by its padded head and let the old one go.
            dr.spill_payload = dr.spill_payload[:s_pad].clone()
            if dr.spill_rn is not None:
                dr.spill_rn = dr.spill_rn[:s_pad].clone()
                dr.spill_rs = dr.spill_rs[:s_pad].clone()
        pos_host = pad_rows(dr.spill_pos, s_pad, fill=-1).astype(np.int32)
        extras = ((dr.spill_rn[:s_pad], dr.spill_rs[:s_pad])
                  if dr.spill_rn is not None else (None, None))
        spill = Spill(dr.spill_payload[:s_pad],
                      up(pad_rows(dr.spill_assign, s_pad).astype(np.int32)),
                      up(pos_host), pos_host, n, *extras,
                      up(spill_offsets(dr.spill_assign, self.nlist)))
        return lay, spill

    def _sort_spill(self) -> None:
        """Put the spill rows in the host layout's order (by list, then
        insertion) in place; appends keep insertion order in between."""
        dr = self._dr
        n = dr.spill_n
        assign = dr.spill_assign
        if (np.diff(assign) >= 0).all():
            return
        perm = np.argsort(assign, kind="stable")
        p = torch.from_numpy(perm).to(self.device)
        dr.spill_payload[:n] = dr.spill_payload[:n].index_select(0, p)
        if dr.spill_rn is not None:
            dr.spill_rn[:n] = dr.spill_rn[:n].index_select(0, p)
            dr.spill_rs[:n] = dr.spill_rs[:n].index_select(0, p)
        dr.spill_assign = assign[perm]
        dr.spill_pos = dr.spill_pos[perm]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        spilled = dr.slot < 0
        dr.slot[spilled] = -(inv[-dr.slot[spilled] - 1] + 1)

    def _device_reconstruct(self, key: int) -> np.ndarray:
        """The stored row of storage position ``key``, fetched from its slot
        or spill row on the card and decoded."""
        dr = self._dr
        rec = int(dr.slot[key])
        row = (dr.payload[int(self._assign[key]), rec] if rec >= 0
               else dr.spill_payload[-rec - 1]).cpu()
        if self.sq_type is None:
            return row.numpy()
        return sq_decode(row[None], torch.from_numpy(self._sq_vmin),
                         torch.from_numpy(self._sq_scale),
                         self.sq_type)[0].numpy()

    def _device_materialize(self) -> np.ndarray:
        """The stored rows (codes or fp32) in insertion order, gathered on
        the card and fetched once (O(corpus bytes): for checkpoints)."""
        dr = self._dr
        w = dr.payload.shape[2]
        out = dr.payload.new_empty((self.ntotal, w))
        kept = dr.slot >= 0
        if kept.any():
            rows = torch.from_numpy(np.nonzero(kept)[0]).to(self.device)
            at = torch.from_numpy(self._assign[kept].astype(np.int64)
                                  * dr.lmax + dr.slot[kept]).to(self.device)
            out[rows] = dr.payload.view(-1, w).index_select(0, at)
        if not kept.all():
            rows = torch.from_numpy(np.nonzero(~kept)[0]).to(self.device)
            at = torch.from_numpy(-dr.slot[~kept] - 1).to(self.device)
            out[rows] = dr.spill_payload.index_select(0, at)
        return out.cpu().numpy()
