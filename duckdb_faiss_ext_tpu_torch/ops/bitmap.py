"""Dense selection-bitmap builder (__faiss_create_mask's hot kernel).

Equivalent of ProcessSelectionvector (src/faiss_extension.cpp:729-804): turn
(flag, id) pairs into a dense LSB-first bitmap sized to max(id)+1, with a
sequential-id fast path (the reference's aligned 8-lane bit-pack loop,
:789-796) and a scatter fallback for arbitrary ids (:770-778).

This is the numpy path; its output is identical to the JAX package's native
bitmap builder, which is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .selectors import BitmapSelector


def build_bitmap(flags: np.ndarray, ids: np.ndarray) -> BitmapSelector:
    flags = np.asarray(flags)
    if flags.dtype != np.uint8:
        flags = flags.astype(np.uint8)
    ids = np.asarray(ids, dtype=np.int64)
    if flags.shape != ids.shape:
        raise ValueError("flags and ids must have the same length")
    n = ids.size
    if n == 0:
        return BitmapSelector(0, np.zeros(0, np.uint8))

    size = int(ids.max()) + 1
    nbytes = (size + 7) // 8

    # Sequential fast path: ids are 0..n-1 in order → one packbits call.
    if size == n and ids[0] == 0 and ids[-1] == n - 1 \
            and np.array_equal(ids, np.arange(n, dtype=np.int64)):
        bitmap = np.packbits(flags.astype(bool), bitorder="little")
        bitmap = np.pad(bitmap, (0, nbytes - bitmap.size))
        return BitmapSelector(size, bitmap)

    # Scatter fallback.
    dense = np.zeros(size, dtype=bool)
    dense[ids[flags != 0]] = True
    bitmap = np.packbits(dense, bitorder="little")
    bitmap = np.pad(bitmap, (0, nbytes - bitmap.size))
    return BitmapSelector(size, bitmap)
