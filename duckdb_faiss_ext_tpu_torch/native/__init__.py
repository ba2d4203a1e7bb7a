"""Native (C++) host-side pieces, loaded through ctypes.

The counterpart of ``duckdb_faiss_ext_tpu/native/``: ``bitmapper.cpp`` (a
copy of the JAX package's source) holds the selection-bitmap construction with
its 8-wide packing loop (the reference's ProcessSelectionvector,
src/faiss_extension.cpp:789-796) and the S-way merge of sorted top-k lists
that the multi-process search runs on the host (parallel/multihost.py).

The library is built with ``g++`` at first use into
``duckdb_faiss_ext_tpu_torch/build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source is rebuilt and a stale library
is never loaded; a file lock keeps concurrent processes from building it
twice.  A failed build raises with the compiler's output: unlike the JAX
package, which returned None and went on in numpy, nothing falls back
silently.  The numpy versions below (``build_bitmap_reference``,
``merge_topk_reference``) are the plain versions the tests hold the
native code against.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bitmapper.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
#: shards the native merge takes (its stack array of shard heads)
MAX_SHARDS = 4096

_lock = threading.Lock()
_lib: "NativeLib | None" = None


class NativeLib:
    """The loaded library's two entry points on numpy arrays."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.dfx_build_bitmap.restype = None
        lib.dfx_build_bitmap.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        lib.dfx_merge_topk.restype = None
        lib.dfx_merge_topk.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]

    def build_bitmap(self, flags: np.ndarray, ids: np.ndarray,
                     nbytes: int) -> np.ndarray:
        """LSB-first bitmap of ``nbytes`` bytes with bit ids[i] set where
        flags[i] != 0 (flags uint8, ids int64 in [0, 8·nbytes))."""
        flags = np.ascontiguousarray(flags, np.uint8)
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.zeros(nbytes, np.uint8)
        self._lib.dfx_build_bitmap(flags.ctypes.data, ids.ctypes.data,
                                   ids.size, out.ctypes.data, nbytes)
        return out

    def merge_topk(self, dists: np.ndarray, labels: np.ndarray,
                   descending: bool) -> tuple[np.ndarray, np.ndarray]:
        """Merge S sorted (best-first) top-k lists per query, (S, nq, k)
        each, into (nq, k); ties go to the lower shard."""
        dists = np.ascontiguousarray(dists, np.float32)
        labels = np.ascontiguousarray(labels, np.int64)
        s, nq, k = dists.shape
        if s > MAX_SHARDS:
            raise ValueError(f"merge_topk: {s} shards exceed {MAX_SHARDS}")
        out_d = np.empty((nq, k), np.float32)
        out_l = np.empty((nq, k), np.int64)
        self._lib.dfx_merge_topk(dists.ctypes.data, labels.ctypes.data, s,
                                 nq, k, int(descending), out_d.ctypes.data,
                                 out_l.ctypes.data)
        return out_d, out_l


def library_path() -> Path:
    """The library built from the source: named by a hash of its bytes and
    the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libdfx_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():
                return
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o",
                                   str(tmp)], capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {_SRC.name} ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_native() -> NativeLib:
    """The native library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            _lib = NativeLib(ctypes.CDLL(str(so)))
        return _lib


def build_bitmap_reference(flags: np.ndarray, ids: np.ndarray,
                           nbytes: int) -> np.ndarray:
    """Plain numpy version of ``NativeLib.build_bitmap``: one packbits
    call over sequential ids, else a scatter into a dense bool map."""
    flags = np.asarray(flags, np.uint8)
    ids = np.asarray(ids, np.int64)
    n = ids.size
    if n and ids[0] == 0 and ids[-1] == n - 1 \
            and np.array_equal(ids, np.arange(n, dtype=np.int64)):
        bitmap = np.packbits(flags != 0, bitorder="little")
    else:
        dense = np.zeros(8 * nbytes, dtype=bool)
        dense[ids[flags != 0]] = True
        bitmap = np.packbits(dense, bitorder="little")
    return np.pad(bitmap, (0, nbytes - bitmap.size))[:nbytes]


def merge_topk_reference(dists: np.ndarray, labels: np.ndarray,
                         descending: bool, k: int | None = None):
    """Plain numpy version of ``NativeLib.merge_topk``: the shards' lists
    flattened shard-major per query and stably sorted (missing slots, label
    -1, last; they come out as (±inf, -1))."""
    s, nq, kk = dists.shape
    k = kk if k is None else k
    flat_d = dists.transpose(1, 0, 2).reshape(nq, s * kk)
    flat_l = labels.transpose(1, 0, 2).reshape(nq, s * kk)
    sentinel = -np.inf if descending else np.inf
    key = np.where(flat_l < 0, sentinel, flat_d)
    order = np.argsort(-key if descending else key, axis=1,
                       kind="stable")[:, :k]
    lab = np.take_along_axis(flat_l, order, axis=1)
    dist = np.where(lab < 0, sentinel, np.take_along_axis(flat_d, order, 1))
    return dist.astype(np.float32), lab
