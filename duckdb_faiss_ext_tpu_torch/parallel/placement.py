"""Index placement: the faiss_to_gpu analogue.

The reference clones a CPU index onto one GPU
(faiss::gpu::index_cpu_to_gpu, src/gpu/gpu.cpp:44-48).  The JAX package
re-shards the index's arrays over a ``jax.sharding.Mesh``; here a
``Mesh`` is a (shard, batch) grid of ``torch.device``s, an index's
storage is cut into one row block (or one group of lists) a shard, and a
search runs the port's single-device search on every shard and merges
(parallel/sharded.py).

A device may repeat in the grid: S shards can live on one card (or, in the
tests, on the CPU).  This stands in for the JAX package's virtual device
count, which gives one host many XLA devices.  ``faiss_to_device(name)``
with no devices still means every local device: every visible card, or
the CPU under ``set_device("cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidInputError
from ..utils.config import resolve_device


class Mesh:
    """A (shard, batch) grid of devices.  Corpus rows (or IVF lists) are
    partitioned over ``shard`` and replicated over ``batch``; a query batch
    is split over ``batch``."""

    def __init__(self, devices):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = _indexed(devices[idx[0]][idx[1]])
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError("a mesh needs a non-empty 2-D grid of devices")
        self.devices = arr

    @property
    def shape(self) -> dict:
        return {"shard": self.devices.shape[0],
                "batch": self.devices.shape[1]}

    def shard_devices(self, s: int) -> list[torch.device]:
        """The distinct devices of shard ``s`` (its row of the grid)."""
        return list(dict.fromkeys(self.devices[s]))


def _indexed(dev) -> torch.device:
    """``dev`` as a torch.device with its index (``cuda`` → ``cuda:i`` of
    the current device), so equal devices compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices() -> list[torch.device]:
    """Every visible card, or the CPU under ``set_device("cpu")``."""
    dev = resolve_device()
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(devices=None) -> Mesh:
    """(shard x batch=1) mesh.  ``devices`` may be None (every local
    device), an int device index (the reference's ``faiss_to_gpu(name,
    device)`` form, src/gpu/gpu.cpp:34-63: ``cuda:i``, or the CPU under
    ``set_device("cpu")``), a ``torch.device`` or device string, or an
    iterable of those; a device may repeat."""
    local = local_devices()
    if devices is None:
        devices = local
    elif isinstance(devices, (int, str, torch.device)):
        devices = [devices]
    resolved = []
    for dev in devices:
        if isinstance(dev, (int, np.integer)) and not isinstance(dev, bool):
            if not 0 <= dev < len(local):
                # Mirrors "Invalid GPU index" (src/gpu/gpu.cpp:57).
                raise InvalidInputError(
                    f"Invalid device index: {dev} "
                    f"({len(local)} devices available)")
            dev = local[dev]
        resolved.append(torch.device(dev))
    return Mesh([[d] for d in resolved])


def shard_entry(entry, devices=None) -> None:
    """Place an index's storage over a device mesh (rows over 'shard')."""
    from ..models.flat import FlatIndex
    from ..models.idmap import IDMapIndex
    from ..models.pretransform import PreTransformIndex
    from ..models.refine import RefineFlatIndex

    mesh = devices if isinstance(devices, Mesh) else default_mesh(devices)
    inner = entry.index
    # Unwrap the composition wrappers down to the storage-owning index:
    # IDMap and PreTransform delegate wholly; RefineFlat places BOTH parts,
    # the compressed base and the raw fp32 refine store (its rerank gathers
    # k_factor·k rows a query from the blocks).
    while True:
        if isinstance(inner, (IDMapIndex, PreTransformIndex)):
            inner = inner.inner
        elif isinstance(inner, RefineFlatIndex):
            _place_flat(inner.refine, mesh)
            inner = inner.base
        else:
            break
    if isinstance(inner, FlatIndex):
        _place_flat(inner, mesh)
        return
    shard = getattr(inner, "shard_over", None)
    if shard is not None:
        shard(mesh)
        return
    # Mirrors the reference's unsupported-type error (src/gpu/gpu.cpp:52-58).
    raise InvalidInputError(
        f"Index of type {type(inner).__name__} cannot be sharded over devices")


def _place_flat(index, mesh: Mesh) -> None:
    # Sticky: the index re-materialises with this placement after adds
    # (capacity rounded to the mesh's device count).
    index.set_placement(RowPlacement(mesh))
    index.device_vectors()


class RowPlacement:
    """Row placement of a padded (cap, ...) buffer over a mesh's 'shard'
    axis (the JAX package's ``NamedSharding(mesh, P("shard", None))``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def capacity(self, cap: int) -> int:
        """``cap`` rounded up to a multiple of the mesh's device count, so
        every shard's block has the same rows."""
        n_dev = self.mesh.devices.size
        return n_dev * -(-cap // n_dev)

    def place(self, host: np.ndarray, home) -> "RowBlocks":
        return RowBlocks(self.mesh, host, home)


class RowBlocks:
    """A padded (cap, ...) buffer as S row blocks of cap / S rows, block s
    on each distinct device of shard s.  Reads of the whole buffer (a
    slice, or a gather by global row) land on ``device`` (the index's
    own); ``block(s, dev)`` is what a shard's search reads."""

    def __init__(self, mesh: Mesh, host: np.ndarray, home):
        nshards = mesh.shape["shard"]
        cap = host.shape[0]
        if cap % nshards:
            raise ValueError(f"{cap} rows do not split into {nshards} shards")
        self.mesh = mesh
        self.rows = cap // nshards
        self.shape = tuple(host.shape)
        self.device = torch.device(home)
        self._blocks = []
        for s in range(nshards):
            t = torch.from_numpy(
                np.ascontiguousarray(host[s * self.rows:(s + 1) * self.rows]))
            self._blocks.append({dev: t.to(dev)
                                 for dev in mesh.shard_devices(s)})
        self.dtype = self._blocks[0][mesh.devices[0, 0]].dtype

    @property
    def nshards(self) -> int:
        return len(self._blocks)

    def block(self, s: int, dev=None) -> torch.Tensor:
        blocks = self._blocks[s]
        return blocks[torch.device(dev)] if dev is not None \
            else next(iter(blocks.values()))

    def nvalid(self, s: int, n: int) -> int:
        """Rows of block s below global row ``n``."""
        return max(0, min(self.rows, n - s * self.rows))

    def write(self, start: int, rows: np.ndarray) -> None:
        """Copy host ``rows`` into global rows [start, start + len) of every
        block copy they fall in."""
        src = torch.from_numpy(rows)
        end = start + rows.shape[0]
        for s, blocks in enumerate(self._blocks):
            lo, hi = max(start, s * self.rows), min(end, (s + 1) * self.rows)
            if lo < hi:
                for blk in blocks.values():
                    blk[lo - s * self.rows:hi - s * self.rows].copy_(
                        src[lo - start:hi - start])

    def __getitem__(self, idx) -> torch.Tensor:
        """A slice of rows, or a gather by a tensor of global rows (any
        shape, every entry in [0, cap)), on ``device``."""
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self.shape[0])
            if step != 1:
                raise ValueError("RowBlocks slices take step 1")
            parts = []
            for s in range(self.nshards):
                lo = max(start, s * self.rows)
                hi = min(stop, (s + 1) * self.rows)
                if lo < hi:
                    parts.append(self.block(s)[lo - s * self.rows:
                                               hi - s * self.rows]
                                 .to(self.device))
            if not parts:
                return torch.empty((0, *self.shape[1:]), dtype=self.dtype,
                                   device=self.device)
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        idx = torch.as_tensor(idx).to(self.device).long()
        out = torch.empty((*idx.shape, *self.shape[1:]), dtype=self.dtype,
                          device=self.device)
        shard = idx // self.rows
        for s in range(self.nshards):
            sel = shard == s
            blk = self.block(s)
            local = (idx[sel] - s * self.rows).to(blk.device)
            out[sel] = blk[local].to(self.device)
        return out
