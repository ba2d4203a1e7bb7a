"""Dense selection-bitmap builder (__faiss_create_mask's hot kernel).

Equivalent of ProcessSelectionvector (src/faiss_extension.cpp:729-804): turn
(flag, id) pairs into a dense LSB-first bitmap sized to max(id)+1, with a
sequential-id fast path (the reference's aligned 8-lane bit-pack loop,
:789-796) and a scatter fallback for arbitrary ids (:770-778).

The bitmap is built by the native library (native/bitmapper.cpp, the JAX
package's C++ source, built with g++ at first use); a failed build raises.
``native.build_bitmap_reference`` is its plain numpy version.
"""

from __future__ import annotations

import numpy as np

from ..native import load_native
from .selectors import BitmapSelector


def build_bitmap(flags: np.ndarray, ids: np.ndarray) -> BitmapSelector:
    flags = np.asarray(flags)
    if flags.dtype != np.uint8:
        flags = flags.astype(np.uint8)
    ids = np.asarray(ids, dtype=np.int64)
    if flags.shape != ids.shape:
        raise ValueError("flags and ids must have the same length")
    if ids.size == 0:
        return BitmapSelector(0, np.zeros(0, np.uint8))
    if int(ids.min()) < 0:
        # The native scatter writes byte id >> 3: a negative id would land
        # outside the bitmap.
        raise ValueError("mask ids must be non-negative")
    size = int(ids.max()) + 1
    return BitmapSelector(size, load_native().build_bitmap(
        flags.reshape(-1), ids.reshape(-1), (size + 7) // 8))
