"""Selection-vector selectors for filtered search.

Equivalents of ``faiss::IDSelectorBitmap`` / ``IDSelectorBatch``
(src/faiss_extension.cpp:959,1008).  FAISS consults the selector per candidate
inside its scan loops; here a selector resolves to a boolean row mask that the
search kernel fuses into the distance scan (masked lanes → sentinel score), so
filtering costs zero extra memory traffic.

* ``BitmapSelector`` — dense bitmap over the id space, O(n) to build; id ``i``
  passes iff bit ``i`` is set.  Built by ops.bitmap (with the sequential-id
  fast path mirroring ProcessSelectionvector, src/faiss_extension.cpp:729-804).
* ``SetSelector`` — explicit id set, O(m); membership via sorted search.

Masks are resolved against an index's ``row_labels()`` (custom labels for
IDMap, positions otherwise) and cached per (selector, index version).

The IVF layouts' per-(list, slot) masks are built on the device
(``device_row_mask``, the JAX package's ``labels_for_device_mask`` /
``device_row_mask``): the packed bitmap (n/8 bytes) or the sorted id set
is uploaded once per selector and device, the label table once per index
version, and the mask is a gather and a bit test (or a sorted search) over
the layout's row positions, which already live on the device.  An IDMap
wrapper hands its inner index a ``LabelMapSelector``: the label-space
selector with the wrapper's position → label table, which the device mask
gathers through as well, so no label is tested on the host.  Labels stay
int64 throughout: the JAX package cast the bit index to int32 (x64 off),
which truncated ids of 2^31 and above, and fell back to the host for label
tables past 2^31 and bitmaps of 2^31 bits or more; neither limit exists
here, so neither does that fallback.  ``host_row_mask`` is the plain
version (``selector.contains`` over every label on the host, scattered
through the host row positions).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

# Process-unique selector ids: mask caches key on these.  (id(self) is NOT
# usable — CPython reuses addresses after GC, which would silently serve a
# stale mask built for a dead selector with a different predicate.)
_SELECTOR_IDS = itertools.count()


class Selector:
    def __init__(self):
        self._uid = next(_SELECTOR_IDS)

    def contains(self, labels: np.ndarray) -> np.ndarray:
        """Vectorised membership: bool mask over int64 labels."""
        raise NotImplementedError

    def cache_key(self):
        """Hashable identity for per-index mask caching (unique per
        selector instance for the process lifetime)."""
        return self._uid


class BitmapSelector(Selector):
    """Dense bitmap: label l passes iff bitmap[l >> 3] >> (l & 7) & 1.

    Same layout as faiss::IDSelectorBitmap (LSB-first within each byte),
    which is what the reference's native bitmap builder produces
    (src/faiss_extension.cpp:789-796)."""

    def __init__(self, nbits: int, bitmap: np.ndarray):
        super().__init__()
        self.nbits = int(nbits)
        self.bitmap = np.asarray(bitmap, dtype=np.uint8)
        if self.bitmap.size < (self.nbits + 7) // 8:
            raise ValueError("bitmap too small for nbits")

    @classmethod
    def from_bool(cls, flags: np.ndarray) -> "BitmapSelector":
        flags = np.asarray(flags, dtype=bool)
        return cls(flags.size, np.packbits(flags, bitorder="little"))

    def contains(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels, dtype=np.int64)
        in_range = (labels >= 0) & (labels < self.nbits)
        safe = np.where(in_range, labels, 0)
        bits = (self.bitmap[safe >> 3] >> (safe & 7)) & 1
        return (bits.astype(bool)) & in_range


class SetSelector(Selector):
    """Explicit id set (faiss::IDSelectorBatch analogue)."""

    def __init__(self, ids: np.ndarray):
        super().__init__()
        self.ids = np.unique(np.asarray(ids, dtype=np.int64))

    def contains(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels, dtype=np.int64)
        if self.ids.size == 0:
            return np.zeros(labels.shape, dtype=bool)
        pos = np.searchsorted(self.ids, labels)
        pos = np.clip(pos, 0, self.ids.size - 1)
        return self.ids[pos] == labels


class LabelMapSelector(Selector):
    """A label-space selector seen from storage positions through a
    position → label table (an IDMap wrapper's): position p passes iff
    ``base`` passes ``table[p]``.  ``device_table(device)`` gives the table
    as ``device_row_mask`` reads it (``labels_for_device_mask``: None where
    the labels are the positions), uploaded once per device by its owner."""

    def __init__(self, base: Selector, table: np.ndarray, device_table):
        super().__init__()
        self.base = base
        self.table = table
        self.device_table = device_table

    def contains(self, positions: np.ndarray) -> np.ndarray:
        positions = np.asarray(positions, dtype=np.int64)
        out = np.zeros(positions.shape, dtype=bool)
        ok = (positions >= 0) & (positions < self.table.size)
        out[ok] = self.base.contains(self.table[positions[ok]])
        return out

    def cache_key(self):
        # The table only grows between the owner's resets, so its length
        # tells its versions apart.
        return ("labelmap", self.base.cache_key(), self.table.size)


# --- layout masks -----------------------------------------------------------

def host_row_mask(selector: Selector, labels: np.ndarray,
                  row_pos: np.ndarray) -> np.ndarray:
    """Plain version of ``device_row_mask``: int8 pass mask of the shape of
    ``row_pos`` (storage rows, -1 where empty), from
    ``selector.contains(labels)`` on the host."""
    passing = selector.contains(labels)
    mask = np.zeros(row_pos.shape, np.int8)
    valid = row_pos >= 0
    mask[valid] = passing[row_pos[valid]]
    return mask


def labels_for_device_mask(ids: np.ndarray, device) -> torch.Tensor | None:
    """The label table of the device mask path: None where the labels are
    the storage positions themselves (no upload, no gather), else the ids
    as an int64 tensor on ``device``.  Callers cache it per index version:
    uploading the label table on every filtered call would cost more than
    the host mask it replaces."""
    n = ids.shape[0]
    if not n or (ids[0] == 0 and ids[-1] == n - 1
                 and np.array_equal(ids, np.arange(n, dtype=ids.dtype))):
        return None
    return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(device)


def _uploaded(selector: Selector, device: torch.device) -> torch.Tensor:
    """The selector's bitmap (uint8) or sorted id set (int64) on
    ``device``, uploaded once per selector and device."""
    cache = selector.__dict__.setdefault("_device_copies", {})
    hit = cache.get(device)
    if hit is None:
        host = (selector.bitmap if isinstance(selector, BitmapSelector)
                else selector.ids)
        hit = cache[device] = torch.tensor(host, device=device)
    return hit


def device_row_mask(selector: Selector, row_pos: torch.Tensor,
                    labels: torch.Tensor | None) -> torch.Tensor:
    """int8 pass mask of the shape of ``row_pos`` (int32 storage rows on the
    device, -1 where empty), built on row_pos's device: each row's label
    (``labels[row]``, or the row itself where ``labels`` is None; through a
    ``LabelMapSelector``'s table after that) tested against the selector's
    bitmap or id set.  Raises TypeError for any other selector: filtered
    IVF search takes the selectors ``create_mask`` and ``SetSelector``
    make."""
    dev = row_pos.device
    table = None
    if isinstance(selector, LabelMapSelector):
        table = selector.device_table(dev)
        selector = selector.base
    if not isinstance(selector, (BitmapSelector, SetSelector)):
        raise TypeError(
            f"filtered IVF search takes a BitmapSelector or a SetSelector, "
            f"not {type(selector).__name__}")
    rp = row_pos.long()
    valid = rp >= 0
    safe_rp = rp.clamp(min=0)
    lab = labels[safe_rp] if labels is not None else safe_rp
    if table is not None:
        lab = table[lab]
    if isinstance(selector, SetSelector):
        if selector.ids.size == 0:
            return torch.zeros(row_pos.shape, dtype=torch.int8, device=dev)
        ids = _uploaded(selector, dev)
        at = torch.searchsorted(ids, lab).clamp(max=ids.shape[0] - 1)
        return ((ids[at] == lab) & valid).to(torch.int8)
    if selector.nbits == 0:
        return torch.zeros(row_pos.shape, dtype=torch.int8, device=dev)
    bits = _uploaded(selector, dev)
    in_range = valid & (lab >= 0) & (lab < selector.nbits)
    safe = torch.where(in_range, lab, 0)
    bit = (bits[safe >> 3].long() >> (safe & 7)) & 1
    return ((bit != 0) & in_range).to(torch.int8)
