"""Build and load the package's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` for Hopper
(``sm_90a``), one compiler process per source, all started together, and
links the objects into one shared library with a plain C interface, which
is loaded with ctypes.  The library is named by a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded;
a file lock keeps concurrent processes from building the same library
twice.  ``nvcc`` is found through ``CUDA_HOME`` or ``/usr/local/cuda/bin``;
without it, loading raises.  ``DeviceCounter`` holds the per-device counts
that kernels add their diagnostics to.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build took in this process (0.0 when the library was
#: already built)
build_seconds = 0.0


class DeviceCounter:
    """One int32 count on each CUDA device, which kernels add to (a
    diagnostic) until a caller zeroes it."""

    def __init__(self) -> None:
        self._counts: dict[int, torch.Tensor] = {}

    def tensor(self, dev) -> torch.Tensor:
        dev = torch.device(dev)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index not in self._counts:
            self._counts[index] = torch.zeros(1, dtype=torch.int32, device=dev)
        return self._counts[index]

    def read(self, dev) -> int:
        """The count on ``dev`` (reads the card: a synchronisation)."""
        return int(self.tensor(dev).item())

    def reset(self, dev) -> None:
        self.tensor(dev).zero_()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA kernels of duckdb_faiss_ext_tpu_torch cannot be built")


def _kernel_files() -> tuple[list[Path], list[Path]]:
    """(sources, each compiled on its own; headers they include)."""
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _library_path(files: list[Path]) -> Path:
    """The library built from ``files`` (sources and headers): named by a
    hash of their names and bytes and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdfx_kernels_{h.hexdigest()[:16]}.so"


def _compile_all(nvcc: str, sources: list[Path], tag: str) -> list[Path]:
    """One ``nvcc -c`` per source, all started together; returns the
    object files or raises with every failing compiler's output."""
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        log = open(BUILD_DIR / f"{src.stem}.{tag}.log", "w+")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=log, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, log, proc))
    failed = []
    for src, obj, log, proc in jobs:
        with log:
            if proc.wait() != 0:
                log.seek(0)
                failed.append(f"{src.name} ({proc.returncode}):\n{log.read()}")
        os.unlink(log.name)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return [obj for _, obj, _, _ in jobs]


def _build(so: Path, sources: list[Path]) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():
                return
            tag = f"{so.stem}.{os.getpid()}"
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            nvcc = find_nvcc()
            objs = _compile_all(nvcc, sources, tag)
            try:
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                     *map(str, objs)],
                    capture_output=True, text=True)
            finally:
                for obj in objs:
                    obj.unlink(missing_ok=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dfx_flat_topk.restype = ctypes.c_int
    lib.dfx_flat_topk.argtypes = [
        p, p, p,            # xb, xq, mask
        i, i, ll, i, i, i,  # nq, d, n_scan, k, k2, l2
        i, i, i, ll,        # qt, vec4, splits, rows_per_split
        i, i, i,            # slots, merge_slots, merge_warps
        p, p, p,            # part_s, part_p, bn_max
        p, p, p,            # out_s, out_p, unproven
        p,                  # stream
    ]
    lib.dfx_ivf_list_scan.restype = ctypes.c_int
    lib.dfx_ivf_list_scan.argtypes = [
        p, p, p, p, p,      # lists, counts, probe_ids, xq, mask
        i, i, i, i, i,      # nq, nprobe, nlist, lmax, d
        i, i,               # l2, vec4
        p, p,               # out, stream
    ]
    plan = ctypes.POINTER(ctypes.c_int)
    lib.dfx_ivf_list_topk.restype = ctypes.c_int
    lib.dfx_ivf_list_topk.argtypes = [
        p, p, p, p, p, p,   # lists, counts, row_pos, probe_ids, xq, mask
        plan, i, i, i, i,   # plan (list_topk.cuh::Plan), d, l2, vec4, lanes
        p, p, p, p,         # part_s, part_p, out_s, out_p
        i, p,               # stages, stream
    ]
    lib.dfx_ivf_pairs.restype = ctypes.c_int
    lib.dfx_ivf_pairs.argtypes = [
        p, p, p, p, p, p,   # lists, counts, xq_t, qs, meta, mask
        i, i, i, i,         # t_max, nlist, lmax, d
        i, i,               # l2, vec4
        p, p,               # out, stream
    ]
    lib.dfx_ivf_pairs_topk.restype = ctypes.c_int
    lib.dfx_ivf_pairs_topk.argtypes = [
        p, p, p, p, p, p,   # lists, counts, row_pos, probe_ids, xq, mask
        p, p, p, p,         # order, ends, item_list, head (the item tables)
        plan,               # plan (pairs_tf32.cuh::Plan)
        p, p, p, p, p,      # part_s, part_p, out_s, out_p, unproven
        i, p,               # stages, stream
    ]
    lib.dfx_ivf_pairs_mega_topk.restype = ctypes.c_int
    lib.dfx_ivf_pairs_mega_topk.argtypes = [
        p, p, p, p, p, p,   # lists, counts, row_pos, probe_ids, xq, mask
        p, p, p, p,         # order, ends, item_list, head (the item tables)
        plan,               # plan (pairs_tf32.cuh::Plan)
        p, p, p, p, p,      # part_s, part_p, out_s, out_p, unproven
        p, i, p,            # grid, stages, stream
    ]
    lib.dfx_ivf_pq_topk.restype = ctypes.c_int
    lib.dfx_ivf_pq_topk.argtypes = [
        p, p, p, p, p,      # lists, counts, rt, row_pos, probe_ids
        p, p, p, p,         # xq, centroids, codebooks, mask
        i, i, i, i, i, i,   # nq, nprobe, nlist, lmax, m, d
        i, i, i, i, i,      # ksub, dsub, k, rq, l2
        i, i, i,            # smem_lut, vec, vec4
        i, i, i, i, i,      # splits, pps, warps, k2, slots
        i, i,               # merge_slots, merge_warps
        p, p, p, p, p,      # lut, cbn, part_s, part_p, cmax
        p, p, p,            # out_s, out_p, unproven
        i, p,               # stages, stream
    ]
    lib.dfx_ivf_sq_scan.restype = ctypes.c_int
    lib.dfx_ivf_sq_scan.argtypes = [
        p, p, p, p, p,      # codes, rn, rs, counts, probe_ids
        p, p, p,            # digits, qs, mask
        i, i, i, i, i,      # nq, nprobe, nlist, lmax, w
        i, i, i,            # codec, l2, vec
        p, p,               # out, stream
    ]
    lib.dfx_ivf_sq_topk.restype = ctypes.c_int
    lib.dfx_ivf_sq_topk.argtypes = [
        p, p, p, p, p, p,   # codes, rn, rs, counts, row_pos, probe_ids
        p, p, p, p, p, p,   # digits, qs, xq, vmin, scale, mask
        plan, i, i, i,      # plan (list_topk.cuh::Plan), d, codec, l2
        i,                  # vec
        p, p, p, p,         # part_s, part_p, cand_s, cand_p
        p, p,               # out_s, out_p
        i, p,               # stages, stream
    ]
    lib.dfx_ivf_sq_pairs.restype = ctypes.c_int
    lib.dfx_ivf_sq_pairs.argtypes = [
        p, p, p, p,         # codes, rn, rs, counts
        p, p, p, p,         # digits, qs, meta, mask
        i, i, i, i,         # t_max, nlist, lmax, w
        i, i, i, i,         # codec, l2, vec, dvec
        i, i, i, i,         # width, chunk, stages, smem
        p, p, p,            # out, plan, stream
    ]
    lib.dfx_ivf_sq_pairs_mega.restype = ctypes.c_int
    lib.dfx_ivf_sq_pairs_mega.argtypes = [
        p, p, p, p,         # codes, rn, rs, counts
        p, p, p, p,         # digits, qs, meta, mask
        i, i, i, i,         # t_max, nlist, lmax, w
        i, i, i, i, i,      # codec, l2, vec, dvec, tma
        p,                  # shape (10 int64: the tensor maps)
        i, i, i, i,         # width, chunk, stages, smem
        p, p, p, p,         # next_tile, out, plan, stream
    ]
    lib.dfx_ivf_pairs_mega.restype = ctypes.c_int
    lib.dfx_ivf_pairs_mega.argtypes = [
        p, p, p, p, p, p,   # lists, counts, xq_t, qs, meta, mask
        i, i, i, i,         # t_max, nlist, lmax, d
        i, i,               # l2, vec4
        p, p, p, p,         # next_tile, out, plan, stream
    ]
    lib.dfx_sq_spill_windows.restype = ctypes.c_int
    lib.dfx_sq_spill_windows.argtypes = [
        p, p, p, p, p,      # codes, pos, rs, rn, mask
        p, p, p, p, p,      # offsets, probe_ids, units, digits, qs
        i, i, i, i,         # nq, nprobe, n_rows, w
        i, i, i,            # codec, l2, vec
        p, p, p, p,         # keys, wmax, warg, stream
    ]
    lib.dfx_sq_spill_rescore.restype = ctypes.c_int
    lib.dfx_sq_spill_rescore.argtypes = [
        p, p, p, p, p,      # codes, assign, pos, mask, probe_ids
        p, p, p, p, p,      # xq, vmin, scale, wsel, warg
        i, i, i, i,         # nq, nprobe, n_rows, nwin
        i, i, i, i,         # k_scan, kw, d, w
        i, i, i,            # codec, l2, words
        p, p,               # out, stream
    ]

def load_library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            sources, headers = _kernel_files()
            so = _library_path(sources + headers)
            if not so.exists():
                _build(so, sources)
            lib = ctypes.CDLL(str(so))
            _bind(lib)
            _lib = lib
        return _lib
