"""Multi-process runtime: the process-group bootstrap, hash partitioning and
the partitioned search.

The counterpart of ``duckdb_faiss_ext_tpu/parallel/multihost.py``.  The
reference is single-process; this is the scale-out tier:

* ``init_multihost`` brings up ``torch.distributed`` with the gloo backend
  (the JAX package: ``jax.distributed``).  Only k-lists cross between
  processes, and they are merged on the host by design, so gloo carries
  them on the CPU and on the card alike; NCCL would also refuse two ranks
  on one card, which is how the demo runs on a one-card machine.
* ``hash_partition`` / ``local_rows``: the deterministic row → process
  assignment (a splitmix64 finaliser, uniform for sequential ids), the same
  assignment as the JAX package's.
* ``merge_host_topk``: the S-way merge of the processes' sorted top-k
  lists on the host, by the native merge (native/bitmapper.cpp).
* ``PartitionedIndex``: a hash-partitioned corpus over S member indexes
  (one a process in a deployment, in-process members in the tests); a
  search fans out and merges the k·S candidates.

``python -m duckdb_faiss_ext_tpu_torch.parallel.multihost_demo`` runs two
processes against each other.
"""

from __future__ import annotations

import numpy as np

from ..native import load_native
from ..ops.flat_search import SIMILARITY_METRICS


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join the process group at ``coordinator_address`` (``host:port``) as
    rank ``process_id`` of ``num_processes``, over gloo; a no-op when no
    address is given (one process) or the group is already up."""
    import torch.distributed as dist

    if coordinator_address is None or dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def hash_partition(ids: np.ndarray, num_partitions: int) -> np.ndarray:
    """Partition of every int64 id (splitmix64 finaliser: uniform even for
    sequential ids, unlike a modulo)."""
    z = np.asarray(ids).astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(num_partitions)).astype(np.int64)


def local_rows(ids: np.ndarray, num_partitions: int | None = None,
               partition: int | None = None) -> np.ndarray:
    """Bool mask of the rows this process owns (the process group's size
    and rank unless given)."""
    world, rank = _world()
    nparts = num_partitions if num_partitions is not None else world
    part = partition if partition is not None else rank
    return hash_partition(ids, nparts) == part


def merge_host_topk(dists: np.ndarray, labels: np.ndarray, metric: str,
                    k: int | None = None):
    """Merge per-shard sorted top-k lists (S, nq, kk) into (nq, k) on the
    host with the native S-way merge (ties to the lower shard; missing
    slots come out as (±inf, -1))."""
    s, nq, kk = dists.shape
    k = kk if k is None else min(int(k), kk)
    d, lab = load_native().merge_topk(dists, labels,
                                      metric in SIMILARITY_METRICS)
    return d[:, :k], lab[:, :k]


class PartitionedIndex:
    """Hash-partitioned corpus over S member indexes: each member owns the
    rows whose label hashes to it, a search fans out to every member and
    the k·S candidates merge on the host.  Exact: every row is owned by
    exactly one member."""

    def __init__(self, members):
        if not members:
            raise ValueError("need at least one member index")
        self.members = list(members)
        d = {m.d for m in self.members}
        if len(d) != 1:
            raise ValueError(f"member dimensions differ: {d}")
        self.d = d.pop()
        self.metric = self.members[0].metric

    @property
    def ntotal(self) -> int:
        return sum(m.ntotal for m in self.members)

    def add_with_ids(self, x, ids) -> None:
        x = np.asarray(x, np.float32)
        ids = np.asarray(ids, np.int64).reshape(-1)
        parts = hash_partition(ids, len(self.members))
        for p, member in enumerate(self.members):
            sel = parts == p
            if sel.any():
                member.add_with_ids(x[sel], ids[sel])

    def add(self, x) -> None:
        start = self.ntotal
        x = np.asarray(x, np.float32)
        self.add_with_ids(x, np.arange(start, start + x.shape[0],
                                       dtype=np.int64))

    def train(self, x) -> None:
        for member in self.members:
            member.train(x)

    def search(self, xq, k, params=None, selector=None):
        from ..models.base import SearchResult
        from ..params import EMPTY

        params = params if params is not None else EMPTY
        results = [m.search(xq, k, params, selector) for m in self.members]
        d, lab = merge_host_topk(np.stack([r.distances for r in results]),
                                 np.stack([r.labels for r in results]),
                                 self.metric.name, k)
        return SearchResult(d, lab)
