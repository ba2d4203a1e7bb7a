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
"""

from __future__ import annotations

import itertools

import numpy as np

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
