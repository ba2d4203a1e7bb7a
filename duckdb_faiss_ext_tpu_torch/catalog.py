"""Named-index catalog: the ObjectCache analogue.

The reference keeps per-name ``FaissIndexEntry`` objects in DuckDB's
in-process ObjectCache (src/include/index.hpp:12-56, accessed e.g.
src/faiss_extension.cpp:148-163).  Each entry carries the index plus the
mutable lifecycle state: the needs-training latch, the loaded-index
immutability rule, the custom-labels latch, and the staging buffers for
deferred training.

Concurrency: the reference guards every index with a coarse exclusive
``faiss_lock`` (src/include/index.hpp:13-14).  Here a per-entry RLock
serialises mutations (add/train/load) only; searches take no lock, and on
the card an in-place add and a search are ordered by the CUDA stream they
are both enqueued on.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from . import errors
from .models.base import Index


@dataclasses.dataclass
class IndexEntry:
    index: Index
    #: True until the index has been trained (via deferred add-train or
    #: faiss_manual_train); drives faiss_add's buffering (index.hpp:27).
    needs_training: bool
    #: Loaded-from-disk trained indexes are immutable
    #: (isMutable = needs_training on load, src/faiss_extension.cpp:238).
    is_mutable: bool = True
    #: Custom-labels latch: None = undecided, True/False latched by the first
    #: faiss_add (LABELSTATE, src/include/index.hpp:6-10).
    custom_labels: Optional[bool] = None
    #: Staging buffers for the deferred-training add path
    #: (entry.add_data/add_labels, src/faiss_extension.cpp:534-544).
    add_data: list = dataclasses.field(default_factory=list)
    add_labels: list = dataclasses.field(default_factory=list)
    #: Rows already pushed into the index (entry.added, index.hpp:38-44).
    added: int = 0
    lock: threading.RLock = dataclasses.field(default_factory=threading.RLock)

    def staged_vectors(self) -> np.ndarray:
        if not self.add_data:
            return np.empty((0, self.index.d), dtype=np.float32)
        return np.concatenate(self.add_data, axis=0)

    def staged_labels(self) -> np.ndarray:
        if not self.add_labels:
            return np.empty((0,), dtype=np.int64)
        return np.concatenate(self.add_labels, axis=0)


class Catalog:
    """Thread-safe name → IndexEntry registry."""

    def __init__(self):
        self._entries: dict[str, IndexEntry] = {}
        self._lock = threading.Lock()

    def put_new(self, name: str, entry: IndexEntry) -> None:
        with self._lock:
            if name in self._entries:
                # src/faiss_extension.cpp:150-152
                raise errors.index_already_exists(name)
            self._entries[name] = entry

    def put(self, name: str, entry: IndexEntry) -> None:
        with self._lock:
            self._entries[name] = entry

    def get(self, name: str) -> IndexEntry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise errors.index_not_found(name) from None

    def delete(self, name: str) -> None:
        with self._lock:
            if name not in self._entries:
                raise errors.index_not_found(name)
            del self._entries[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


#: Process-global default catalog (the reference's indexes are likewise global
#: per database instance, README.md:105).
GLOBAL_CATALOG = Catalog()
