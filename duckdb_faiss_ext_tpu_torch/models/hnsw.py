"""HNSW / NSG index surface: exact scan, graph walk or internal IVF.

The counterpart of ``duckdb_faiss_ext_tpu/models/hnsw.py``.  The reference
builds faiss::IndexHNSW from factory strings (``HNSW16``,
``IDMap,HNSW32``, ``IDMap,HNSW128,Flat``) and tunes it through
``efConstruction`` at create time and ``efSearch`` at search time
(src/faiss_extension.cpp:133-141, 691-702).  The rows are stored fp32
whatever storage the description names (``HNSW32,SQ8`` too, as in the JAX
package), and a search takes one of three regimes:

* ``exact`` below ``ann_threshold`` rows, for metrics other than L2 and
  inner product, and under ``{"exact": "true"}``: FlatIndex's scan, which
  sends L2 / inner product to the fused kernel K1;
* ``graph`` (the default at scale): the batched walk over a CAGRA-style
  graph (ops/graph.py) of degree min(128, max(16, 2M)), built on the first
  search under a lock; efSearch sets the walk's pool;
* ``ivf`` under ``accel=ivf``, ``soar_lambda`` or a checkpoint that holds
  a partition and no graph: an internal IVF,Flat partition (nlist ≈ √n,
  capped at 65,536) searched at nprobe = efSearch / 4 through K6 / K7.

Under a placement (faiss_to_device: the rows as S blocks over a mesh,
models/flat.py) the graph regime is ``graph_sharded``: each shard builds a
graph over its own row block (``build_graph`` on K1, local row indices,
padded with -1 to the block's rows) and a search walks every shard's
subgraph and merges the shards' top-k (parallel/sharded.py); a filtered
search, ``exact`` and the IVF regime's cases take the sharded exact scan
(K1 on every block).  The per-shard graphs are not saved (placements are
not), and the host adjacency of an earlier single-device build is kept.

Rows added after a build are scanned exactly (K1) and merged until they
pass ``tail_rebuild_fraction`` of the corpus, which triggers a rebuild.
Rows ingested on the device (``add_device``, models/flat.py) are built
over and walked in their buffer, which the adjacency then matches row for
row.  A build runs in the span ``models.graph_build`` (counted in
``models.graph_builds``; its stages' spans are ops/graph.py's), a walk in
``models.graph_walk`` (counted in ``models.graph_walks``).
Not ported: the pack-budget degree backoff (a v5e allocation cap).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..ops import graph as graph_ops
from ..ops.flat_search import SIMILARITY_METRICS, finalize_scores
from ..params import EMPTY, ParamMap
from ..utils.config import config, next_pow2
from ..utils.profiling import build_span, count, span, timed
from ..utils.transfer import upload_query_batch
from .base import Dispatch, SearchResult, as_matrix
from .flat import FlatIndex

#: walk dispatches served (single-device and sharded)
GRAPH_WALKS = "models.graph_walks"
count(GRAPH_WALKS, 0)


class HNSWIndex(FlatIndex):
    #: rows from which the graph (or IVF) regime takes over from the scan
    ann_threshold = 200_000
    #: rebuild when rows added since the build exceed this fraction
    tail_rebuild_fraction = 0.2
    #: rows up to which the graph build is the exact k-NN scan
    graph_max = graph_ops.EXACT_MAX

    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 M: int = 32, storage_label: str = "Flat"):
        super().__init__(d, metric, metric_arg)
        self.M = int(M)
        #: the storage the description names ("Flat", "SQ8", "PQ8", ...);
        #: the rows stay fp32 either way.  Kept apart from FlatIndex's
        #: ``storage`` (the buffer's dtype), which the JAX package
        #: overwrites with it, losing its Pallas scan in the exact regime.
        self.storage_label = storage_label
        self.ef_construction = 40  # faiss::HNSW default
        self.ef_search = 16        # faiss::HNSW default
        self.accel_mode = "graph"
        self.soar_lambda = 0.0
        #: (host adjacency (indexed, deg) int32, indexed), or None
        self._graph = None
        #: ((indexed, cap), the adjacency padded to cap rows on the device)
        self._graph_dev = None
        #: (IVFIndex over the first `indexed` rows, indexed), or None
        self._accel = None
        #: per-shard graphs under a placement: (cap, per shard {device:
        #: (rows, deg) int32 adjacency in local indices}, per-shard valid
        #: rows, indexed), or None
        self._graph_sharded = None
        self._tail_cache = None
        #: one lazy build (graph or partition) under concurrent searches
        self._build_lock = threading.Lock()

    def apply_create_params(self, params) -> None:
        ef = params.get_int("efConstruction")
        if ef is not None:
            self.ef_construction = ef
        at = params.get_int("ann_threshold")
        if at is not None:
            self.ann_threshold = at
        mode = params.get_str("accel")
        if mode is not None:
            if mode not in ("graph", "ivf"):
                raise errors.InvalidInputError(
                    f"accel must be 'graph' or 'ivf', got {mode!r}")
            self.accel_mode = mode
        lam = params.get_float("soar_lambda")
        if lam is not None:
            if lam < 0.0:
                raise errors.InvalidInputError(
                    f"soar_lambda must be >= 0, got {lam}")
            self.soar_lambda = lam

    # --- regime selection ---------------------------------------------------
    def _effective_mode(self) -> str:
        """'exact', 'graph', 'graph_sharded' or 'ivf' for the current corpus
        and knobs; under a placement the graph regime is per-shard and the
        IVF regime's cases take the exact scan."""
        if (self.ntotal < self.ann_threshold
                or self.metric.name not in ("L2", "INNER_PRODUCT")):
            return "exact"
        wants_ivf = (self.accel_mode == "ivf" or self.soar_lambda > 0.0
                     or (self._graph is None and self._graph_sharded is None
                         and self._accel is not None))
        if self._placement is not None:
            return "exact" if wants_ivf else "graph_sharded"
        return "ivf" if wants_ivf else "graph"

    def set_placement(self, placement) -> None:
        """Re-placement moves the row blocks: the per-shard graphs (local
        indices) no longer align, and the single-device walk's padded
        adjacency is unreachable under a placement; the host adjacency
        stays (cheap, saved, reused if the placement is dropped)."""
        super().set_placement(placement)
        self._graph_sharded = None
        self._graph_dev = None

    def _stale(self, built) -> bool:
        n = self.ntotal
        return built is None or n - built[1] > self.tail_rebuild_fraction * n

    # --- graph regime -------------------------------------------------------
    def _graph_degree(self) -> int:
        """HNSW's layer-0 degree 2M, within [16, 128]."""
        return min(128, max(16, 2 * self.M))

    def _graph_ready(self):
        """(adjacency, indexed) over a prefix of the corpus, rebuilt when
        the exactly scanned tail outgrows the rebuild fraction."""
        if not self._stale(self._graph):
            return self._graph
        with self._build_lock:
            if not self._stale(self._graph):  # another thread built it
                return self._graph
            n = self.ntotal
            deg = self._graph_degree()
            # efConstruction scales build effort: a wider intermediate
            # k-NN graph, and more NN-descent rounds past graph_max.
            inter = min(max(2 * deg, self.ef_construction), max(1, n - 1),
                        192)
            rounds = 2 + max(0, (self.ef_construction - 64) // 64)
            xb = self.device_vectors()
            self._graph = self._graph_dev = None   # free the old adjacency
            with timed("hnsw_graph_build"), build_span("models.graph_build"):
                adj = graph_ops.build_graph(
                    xb, n, deg, self.metric.name, intermediate=inter,
                    exact_max=self.graph_max, refine_rounds=rounds)
            self._graph_dev = ((n, xb.shape[0]), _pad_graph(adj,
                                                            xb.shape[0]))
            self._graph = (adj.cpu().numpy(), n)
            return self._graph

    @property
    def graph(self) -> np.ndarray | None:
        """The built adjacency (indexed rows, degree) int32, -1 padded, as a
        read-only host array; None before the first build."""
        if self._graph is None:
            return None
        adj = self._graph[0].view()
        adj.flags.writeable = False
        return adj

    def _graph_device(self, cap: int, gstate) -> torch.Tensor:
        """The adjacency of ``gstate`` padded to ``cap`` rows on the index's
        device (uploaded once after a load or a capacity change)."""
        adj, indexed = gstate
        key = (indexed, cap)
        hit = self._graph_dev
        if hit is not None and hit[0] == key:
            return hit[1]
        with self._build_lock:
            hit = self._graph_dev
            if hit is None or hit[0] != key:
                hit = (key, _pad_graph(torch.from_numpy(adj).to(self.device),
                                       cap))
                self._graph_dev = hit
            return hit[1]

    def _walk_knobs(self, k: int, params, selector):
        """(pool, width, iters): efSearch sets the pool, a selector
        inflates it (traversal unfiltered, extraction filtered); the
        frontier narrows as the degree grows."""
        pool = next_pow2(max(k, self.ef_search))
        if selector is not None:
            pool = next_pow2(max(4 * k, pool))
        pool = min(max(pool, 16), 1024)
        width = params.get_int("graph_width",
                               max(4, 512 // max(self._graph_degree(), 1)))
        return pool, width, params.get_int("graph_iters")

    def _walk_seeds(self, n: int) -> int:
        """Seed rows the walk scans over a graph of ``n`` rows: the JAX
        package's count over the exact build, a denser sample over the
        clustered one (``graph_ops.clustered_seeds``)."""
        return (graph_ops.WALK_SEEDS if n <= self.graph_max
                else graph_ops.clustered_seeds(n))

    def _graph_dispatch(self, xq, k, params, selector, gstate):
        """The walk as a ``Dispatch`` on the device, or None with no work.
        Everything derives from ``gstate``, so a concurrent rebuild cannot
        pair it with another graph."""
        _, indexed = gstate
        nq = xq.shape[0]
        if nq == 0 or k <= 0 or indexed == 0:
            return None
        xq_pad = upload_query_batch(xq, self.device)
        xb = self.device_vectors()
        gdev = self._graph_device(xb.shape[0], gstate)
        pool, width, iters = self._walk_knobs(k, params, selector)
        mask = self._selector_mask(selector) if selector is not None else None
        k_eff = min(k, indexed)
        with span("models.graph_walk"):
            scores, pos = graph_ops.graph_search(
                xb, gdev, xq_pad, indexed, k_eff, self.metric.name,
                pool=pool, width=width, iters=iters, mask=mask,
                rerank=config.precision_mode != "parity",
                nseed=self._walk_seeds(indexed))
        count(GRAPH_WALKS)
        dist, pos = finalize_scores(scores, pos, self.metric.name)
        return Dispatch(dist, pos, nq, k_eff)

    # --- sharded graph regime ---------------------------------------------
    def _graph_ready_sharded(self):
        """Per-shard graphs over the placed row blocks, rebuilt when the
        exactly scanned tail outgrows the rebuild fraction or the capacity
        (hence the blocks) moved."""
        def fresh():
            g = self._graph_sharded
            if g is None or g[0] != self.device_vectors().shape[0]:
                return None
            n = self.ntotal
            return g if n - g[3] <= self.tail_rebuild_fraction * n else None

        if fresh() is not None:
            return self._graph_sharded
        with self._build_lock:
            if fresh() is not None:
                return self._graph_sharded
            n = self.ntotal
            blocks = self.device_vectors()
            deg = self._graph_degree()
            inter = min(max(2 * deg, self.ef_construction), max(1, n - 1),
                        192)
            rounds = 2 + max(0, (self.ef_construction - 64) // 64)
            graphs, nvalid = [], []
            with timed("hnsw_graph_build"), build_span("models.graph_build"):
                for s in range(blocks.nshards):
                    n_s = blocks.nvalid(s, n)
                    devs = blocks.mesh.shard_devices(s)
                    adj = (graph_ops.build_graph(
                        blocks.block(s, devs[0]), n_s, deg, self.metric.name,
                        intermediate=min(inter, max(1, n_s - 1)),
                        exact_max=self.graph_max, refine_rounds=rounds)
                        if n_s else torch.empty((0, deg), dtype=torch.int32,
                                                device=devs[0]))
                    adj = _pad_graph(adj, blocks.rows)
                    graphs.append({dev: adj.to(dev) for dev in devs})
                    nvalid.append(n_s)
            self._graph_sharded = (blocks.shape[0], graphs, nvalid, n)
            return self._graph_sharded

    def _sharded_graph_dispatch(self, xq, k, params, gstate):
        """The per-shard walks and their merge as a ``Dispatch``."""
        from ..parallel.sharded import sharded_graph_search

        _, graphs, nvalid, indexed = gstate
        nq = xq.shape[0]
        if nq == 0 or k <= 0 or indexed == 0:
            return None
        xq_pad = upload_query_batch(xq, self.device)
        pool, width, iters = self._walk_knobs(k, params, None)
        k_eff = min(k, indexed)
        with span("models.graph_walk"):
            scores, pos = sharded_graph_search(
                self.device_vectors(), graphs, nvalid, xq_pad, k_eff,
                self.metric.name, pool=max(pool, k_eff), width=width,
                iters=iters, rerank=config.precision_mode != "parity",
                nseed=self._walk_seeds(max(nvalid)))
        count(GRAPH_WALKS)
        dist, pos = finalize_scores(scores, pos, self.metric.name)
        return Dispatch(dist, pos, nq, k_eff)

    # --- ivf regime ---------------------------------------------------------
    def _accel_ready(self):
        """(IVFIndex, indexed) over a prefix of the corpus."""
        if not self._stale(self._accel):
            return self._accel
        with self._build_lock:
            if not self._stale(self._accel):
                return self._accel
            from .ivf import IVFIndex

            n = self.ntotal
            nlist = 1
            while nlist * nlist < n:
                nlist *= 2
            accel = IVFIndex(self.d, self.metric, self.metric_arg,
                             nlist=min(nlist, 65_536),
                             quantizer=FlatIndex(self.d, self.metric,
                                                 self.metric_arg))
            # efConstruction scales build effort as k-means iterations.
            accel.train_niter = max(4, min(25, self.ef_construction // 8))
            accel.soar_lambda = self.soar_lambda
            rows = self.vectors()
            accel.train(rows)
            accel.add(rows)   # ids = positions 0..n-1
            self._accel = (accel, n)
            return self._accel

    # --- search -------------------------------------------------------------
    def _latch(self, params) -> None:
        ef = params.get_int("efSearch")
        if ef is not None:
            self.ef_search = ef

    def _exact_search(self, xq, k, params, selector) -> SearchResult:
        return self.finish(
            FlatIndex.search_dispatch(self, xq, k, params, selector),
            xq.shape[0], k)

    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        xq = as_matrix(xq, self.d)
        params = params if params is not None else EMPTY
        self._latch(params)
        mode = self._effective_mode()
        if (_exact_requested(params) or mode == "exact"
                or (mode == "graph_sharded" and selector is not None)):
            # A filtered search under a placement takes the sharded exact
            # scan (the mask fused into K1 on every block).
            return self._exact_search(xq, k, params, selector)
        if mode == "graph_sharded":
            gstate = self._graph_ready_sharded()
            res = self.finish(
                self._sharded_graph_dispatch(xq, k, params, gstate),
                xq.shape[0], k)
            indexed = gstate[3]
        elif mode == "graph":
            gstate = self._graph_ready()
            res = self.finish(
                self._graph_dispatch(xq, k, params, selector, gstate),
                xq.shape[0], k)
            indexed = gstate[1]
        else:
            accel, indexed = self._accel_ready()
            nprobe = params.get_int("nprobe",
                                    max(1, round(self.ef_search / 4)))
            res = accel.search(xq, k, ParamMap(dict(params,
                                                    nprobe=str(nprobe))),
                               selector)
        if indexed == self.ntotal:
            return res
        return _merge_results(res, self._tail_search(xq, k, indexed,
                                                     selector),
                              k, self.metric.name in SIMILARITY_METRICS)

    def _tail_search(self, xq, k, start: int, selector) -> SearchResult:
        """Exact scan (K1) of the rows added after the build, labels shifted
        to corpus positions; the tail index is cached between adds."""
        key = (start, self.ntotal)
        if self._tail_cache is None or self._tail_cache[0] != key:
            tail = FlatIndex(self.d, self.metric, self.metric_arg)
            if self._resident_n is None:
                tail.add(self._xb[start:])
            else:
                tail.add_device(self.device_vectors()[start:self.ntotal])
            self._tail_cache = (key, tail)
        tail = self._tail_cache[1]
        sel = _ShiftedSelector(selector, start) if selector is not None \
            else None
        res = tail.search(xq, k, EMPTY, sel)
        return SearchResult(res.distances,
                            np.where(res.labels >= 0, res.labels + start, -1))

    def search_dispatch(self, xq, k, params=None, selector=None):
        """The exact scan's dispatch, or the walk's when no tail needs a
        host merge; None otherwise (the batched tier then searches each
        batch)."""
        p = params if params is not None else EMPTY
        self._latch(p)
        mode = self._effective_mode()
        if _exact_requested(p) or mode == "exact":
            return FlatIndex.search_dispatch(self, xq, k, p, selector)
        if mode == "graph":
            gstate = self._graph_ready()
            if gstate[1] == self.ntotal:
                return self._graph_dispatch(xq, k, p, selector, gstate)
        return None

    # --- serialization ------------------------------------------------------
    def state_dict(self) -> dict:
        state = super().state_dict()
        state["hnsw_meta"] = np.array(
            [self.M, self.ef_construction, self.ef_search,
             self.ann_threshold, 1 if self.accel_mode == "ivf" else 0])
        if self._graph is not None:
            adj, indexed = self._graph
            state["graph_adj"] = adj
            state["graph_meta"] = np.array([indexed])
        if self.soar_lambda > 0.0:
            state["hnsw_soar"] = np.float32(self.soar_lambda)
        if self._accel is not None:
            accel, indexed = self._accel
            state["accel_centroids"] = accel._centroids
            state["accel_assign"] = accel._assign
            state["accel_meta"] = np.array([accel.nlist, indexed])
        return state

    def load_state(self, state: dict) -> None:
        state = dict(state)
        meta = state.pop("hnsw_meta", None)
        if meta is not None:
            m = [int(v) for v in meta]
            self.M, self.ef_construction, self.ef_search = m[:3]
            if len(m) > 3:
                self.ann_threshold = m[3]
            if len(m) > 4:
                self.accel_mode = "ivf" if m[4] else "graph"
        gadj = state.pop("graph_adj", None)
        gmeta = state.pop("graph_meta", None)
        lam = state.pop("hnsw_soar", None)
        if lam is not None:
            self.soar_lambda = float(lam)
        cents = state.pop("accel_centroids", None)
        assign = state.pop("accel_assign", None)
        ameta = state.pop("accel_meta", None)
        super().load_state(state)
        self._graph = self._graph_dev = self._accel = self._tail_cache = None
        self._graph_sharded = None
        if gadj is not None and gmeta is not None:
            self._graph = (np.array(gadj, np.int32), int(gmeta[0]))
        if cents is not None and ameta is not None:
            self._accel = (self._load_accel(cents, assign, int(ameta[0]),
                                            int(ameta[1])), int(ameta[1]))

    def _load_accel(self, cents, assign, nlist: int, indexed: int):
        """The persisted partition over the first ``indexed`` rows (SOAR's
        copies as a fresh add lays them out), without k-means."""
        from .ivf import IVFIndex

        accel = IVFIndex(self.d, self.metric, self.metric_arg, nlist=nlist,
                         quantizer=FlatIndex(self.d, self.metric,
                                             self.metric_arg))
        rows = np.arange(indexed, dtype=np.int64)
        copies = 2 if self.soar_lambda > 0.0 else 1
        state = {"xb": np.tile(self._xb[:indexed], (copies, 1)),
                 "ids": np.tile(rows, copies),
                 "assign": np.asarray(assign, np.int32).reshape(-1),
                 "centroids": np.asarray(cents, np.float32)}
        if copies == 2:
            state.update(soar_lambda=np.float32(self.soar_lambda),
                         soar_srcrow=np.tile(rows, 2), soar_rows=rows)
        accel.load_state(state)
        return accel


class NSGIndex(HNSWIndex):
    """faiss::IndexNSG surface (``NSG[R]``): the same regimes, the degree
    from R where HNSW takes M, and the pool from ``search_L`` (faiss
    IndexNSG's default 16) where HNSW takes efSearch."""

    def _latch(self, params) -> None:
        super()._latch(params)
        L = params.get_int("search_L")
        if L is not None:
            self.ef_search = L

    def apply_create_params(self, params) -> None:
        super().apply_create_params(params)
        R = params.get_int("R")
        if R is not None:
            self.M = R


def _exact_requested(params) -> bool:
    return (params.get_str("exact") or "").lower() in ("true", "1")


def _pad_graph(adj: torch.Tensor, cap: int) -> torch.Tensor:
    """(indexed, deg) adjacency → (cap, deg), rows past it -1 (the
    adjacency itself where it has cap rows)."""
    if adj.shape[0] == cap:
        return adj
    out = torch.full((cap, adj.shape[1]), -1, dtype=torch.int32,
                     device=adj.device)
    out[:adj.shape[0]] = adj
    return out


def _merge_results(a: SearchResult, b: SearchResult, k: int,
                   sim: bool) -> SearchResult:
    """Best k of two results (missing slots carry ±inf and sort last)."""
    dist = np.concatenate([a.distances, b.distances], axis=1)
    labels = np.concatenate([a.labels, b.labels], axis=1)
    order = np.argsort(-dist if sim else dist, axis=1, kind="stable")[:, :k]
    return SearchResult(np.take_along_axis(dist, order, axis=1),
                        np.take_along_axis(labels, order, axis=1))


class _ShiftedSelector:
    """Selector over tail positions: tail position p is corpus position
    p + start."""

    def __init__(self, inner, start: int):
        self._inner = inner
        self._start = int(start)

    def contains(self, labels: np.ndarray) -> np.ndarray:
        return self._inner.contains(np.asarray(labels) + self._start)

    def cache_key(self):
        return ("shift", self._start, self._inner.cache_key())
