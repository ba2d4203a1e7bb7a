"""Sharded search and training over a device mesh.

The counterpart of ``duckdb_faiss_ext_tpu/parallel/sharded.py``.  The mesh
(parallel/placement.py) has two axes: ``shard`` partitions corpus rows (or
IVF lists), ``batch`` partitions the query batch.  Every (shard, batch)
device searches its part of the corpus for its part of the queries with
the port's single-device search, and the shards' top-k lists are merged:
k·S (score, position) pairs a query, never vectors.

* ``sharded_flat_search``: each shard runs K1 (ops/flat_topk.py, its plain
  version on CPU tensors) over its row block, positions offset by the
  block's first row.  The JAX package ran its sharded scan as XLA under
  ``shard_map``, and its Flat path stepped around its Pallas kernel on a
  sharded buffer (``models/flat.py:198`` there); here every shard takes
  the kernel.
* ``sharded_ivf_search``: the coarse top-nprobe on the replicated
  centroids (the lists in their LPT order, ``balanced_list_partition``);
  each shard runs its encoding's list search on its own lists, every
  probe it does not own pointed at one empty list appended to its lists
  (so the kernels, which take empty lists as they come, need no dead-slot
  handling); every probed list is scanned by exactly one shard.
* ``sharded_graph_search``: each shard walks its own subgraph (local row
  indices) with ops/graph.py::graph_search.
* ``sharded_kmeans_step``: one Lloyd iteration with the assignment split
  over every device of the mesh and the centroid sums added up.

The merge (``merge_shard_topk``) concatenates the shards' lists
shard-major and takes one top-k; equal scores go to the lower shard, then
to the order within it, as ``lax.top_k`` over the JAX package's (nq, S·k)
block does.  Not ported: ``sharded_pack_fn`` (the packed neighbourhoods,
a TPU gather workaround the port does not have), and the fast-mode
inner-product rerank of the sharded IVF scan (the port's IVF scans are fp32
in both precision modes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ivf_layout import ListLayout
from ..ops import flat_topk
from ..ops.flat_search import exact_topk, search_scan
from ..ops.ivf_pq_scan import pq_row_terms
from ..ops.ivf_scan import coarse_topk
from ..ops.kmeans import assign_labels
from .placement import Mesh, RowBlocks, local_devices

_NEG_INF = float("-inf")


def make_mesh(n_devices: int | None = None, batch_axis: int = 1,
              devices=None) -> Mesh:
    """(n / batch_axis) x batch_axis mesh over the local devices, taken in
    turn and repeated where ``n_devices`` is more than there are."""
    devices = list(devices if devices is not None else local_devices())
    if n_devices is not None:
        devices = [devices[i % len(devices)] for i in range(n_devices)]
    n = len(devices)
    if n % batch_axis:
        raise ValueError(f"{n} devices not divisible by batch_axis={batch_axis}")
    return Mesh([devices[r * batch_axis:(r + 1) * batch_axis]
                 for r in range(n // batch_axis)])


def merge_shard_topk(parts, k: int, nq: int, device):
    """Merge the shards' max-oriented (scores (nq, k_s), global positions
    (nq, k_s)), in shard order, into the best k: one top-k over their
    shard-major concatenation (ties to the lower shard, then to the order
    within it).  Returns (scores (nq, k), positions (nq, k) int32), (-inf,
    -1) where missing."""
    best = torch.full((nq, k), _NEG_INF, dtype=torch.float32, device=device)
    pos = torch.full((nq, k), -1, dtype=torch.int32, device=device)
    if parts:
        scores = torch.cat([p[0].to(device) for p in parts], 1)
        cand = torch.cat([p[1].to(device, torch.int32) for p in parts], 1)
        s, sel = exact_topk(scores, k)
        kk = s.shape[1]
        best[:, :kk] = s
        pos[:, :kk] = torch.where(torch.isneginf(s), -1, cand.gather(1, sel))
    return best, pos


def offset_positions(pos: torch.Tensor, base: int) -> torch.Tensor:
    """Local positions of a shard → global ones (-1 stays -1)."""
    return torch.where(pos >= 0, pos + base, -1)


def sharded_search(mesh: Mesh, xq: torch.Tensor, k: int, scan):
    """Run ``scan(s, dev, xq_part, k)`` for every shard s and batch part:
    the queries split into ``batch`` contiguous parts, part b searched on
    the devices of column b; ``scan`` returns max-oriented (scores,
    global positions) or None when the shard holds nothing.  Returns the
    merged (scores, positions) (nq, k) on xq's device."""
    nq = xq.shape[0]
    nb, ns = mesh.shape["batch"], mesh.shape["shard"]
    per = -(-nq // nb)
    out_s, out_p = [], []
    for b in range(nb):
        xq_b = xq[b * per:(b + 1) * per]
        if not xq_b.shape[0]:
            continue
        copies, parts = {}, []
        for s in range(ns):
            dev = mesh.devices[s, b]
            if dev not in copies:
                copies[dev] = xq_b.to(dev)
            part = scan(s, dev, copies[dev], k)
            if part is not None:
                parts.append(part)
        best, pos = merge_shard_topk(parts, k, xq_b.shape[0], xq.device)
        out_s.append(best)
        out_p.append(pos)
    if len(out_s) == 1:
        return out_s[0], out_p[0]
    return torch.cat(out_s), torch.cat(out_p)


def sharded_rows_search(blocks: RowBlocks, nvalid: int, xq: torch.Tensor,
                        k: int, search, mask: torch.Tensor | None = None):
    """Top-k over rows [0, nvalid) of a row-placed buffer through a
    single-device scan: ``search(s, dev, block, n_s, q, k_s, mask_s)``
    returns max-oriented (scores, local positions) over one block; shards
    with no valid row are skipped.  ``mask`` is a (cap,) row mask."""
    rows = blocks.rows

    def scan(s, dev, q, kk):
        n_s = blocks.nvalid(s, nvalid)
        if n_s == 0:
            return None
        m = None if mask is None else mask[s * rows:(s + 1) * rows].to(dev)
        sc, p = search(s, dev, blocks.block(s, dev), n_s, q, min(kk, rows), m)
        return sc, offset_positions(p, s * rows)

    return sharded_search(blocks.mesh, xq, k, scan)


def sharded_flat_search(blocks: RowBlocks, nvalid: int, xq: torch.Tensor,
                        k: int, metric: str, metric_arg: float = 0.0,
                        mask: torch.Tensor | None = None):
    """Top-k over a row-placed fp32 corpus: K1 on every shard's block (the
    plain scan for metrics and k it does not take), then the merge.
    Returns max-oriented (scores, positions) as ``search_scan`` does."""
    def search(s, dev, xb, n, q, kk, m):
        if flat_topk.supports(metric, kk, xq.shape[1]):
            return flat_topk.flat_topk(xb, n, q, kk, metric, m)
        return search_scan(xb, n, q, kk, metric, metric_arg, m)

    return sharded_rows_search(blocks, nvalid, xq, k, search, mask)


def balanced_list_partition(counts, nshards: int) -> np.ndarray:
    """Skew-aware IVF list placement: a greedy LPT bin-pack of ``nlist``
    lists into ``nshards`` groups of nlist / nshards lists each, balancing
    the groups' Σcounts (longest list first, each to the least-loaded shard
    with a slot left).  Returns ``perm`` int32 (nlist,): the old list ids in
    their new order, shard s owning ``perm[s·npl:(s+1)·npl]``; the same
    ``perm`` as the JAX package's function, list for list."""
    counts = np.asarray(counts, np.int64)
    nlist = counts.shape[0]
    if nlist % nshards:
        raise ValueError(f"nlist {nlist} not divisible by {nshards} shards")
    npl = nlist // nshards
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(nshards, np.int64)
    slots = np.full(nshards, npl, np.int64)
    groups = [[] for _ in range(nshards)]
    for li in order:
        open_shards = np.flatnonzero(slots > 0)
        s = open_shards[np.argmin(load[open_shards])]
        groups[s].append(li)
        load[s] += counts[li]
        slots[s] -= 1
    return np.concatenate([np.asarray(g, np.int32) for g in groups])


def shard_lists(mesh: Mesh, perm: np.ndarray, payload: np.ndarray,
                counts: np.ndarray, row_pos: np.ndarray,
                centroids: np.ndarray, *, rn=None, rs=None, codebooks=None,
                codec: str = "pq", metric: str = "L2"):
    """The host padded list layout cut into one sub-layout a shard: shard s
    holds lists ``perm[s·npl:(s+1)·npl]`` and then one empty list (id npl,
    where the probes it does not own point), on each of its devices; row
    positions stay global storage rows.  PQ / RQ sub-layouts carry the
    codebooks and, under L2, their row terms.  Returns, for each shard,
    {device: ListLayout}."""
    nshards = mesh.shape["shard"]
    npl = perm.shape[0] // nshards
    out = []
    for s in range(nshards):
        lists = perm[s * npl:(s + 1) * npl]

        def take(a, fill):
            sub = np.full((npl + 1, *a.shape[1:]), fill, a.dtype)
            np.take(a, lists, axis=0, out=sub[:npl])
            return sub

        host = dict(payload=take(payload, 0), counts=take(counts, 0),
                    row_pos=take(row_pos, -1), centroids=take(centroids, 0),
                    rn=None if rn is None else take(rn, 0),
                    rs=None if rs is None else take(rs, 0))
        per_dev = {}
        for dev in mesh.shard_devices(s):
            up = {key: None if a is None else torch.from_numpy(a).to(dev)
                  for key, a in host.items()}
            lay = ListLayout(up["payload"], up["counts"], up["row_pos"],
                             up["centroids"], host["row_pos"], up["rn"],
                             up["rs"], None if codebooks is None
                             else codebooks.to(dev))
            if codebooks is not None and metric == "L2":
                lay = lay._replace(rt=pq_row_terms(
                    lay.payload, lay.counts, lay.centroids, lay.codebooks,
                    codec))
            per_dev[dev] = lay
        out.append(per_dev)
    return out


def sharded_ivf_search(mesh: Mesh, centroids: torch.Tensor, xq: torch.Tensor,
                       *, nprobe: int, k: int, metric: str,
                       metric_arg: float = 0.0, scan):
    """Sharded IVF search over ``shard_lists`` sub-layouts.  ``centroids``
    (S·npl, d) are the lists in shard order; every (shard, batch) device
    takes the coarse top-nprobe of its queries on its copy of them, keeps
    the probes of its own lists as local ids (npl for the others: its empty
    list) and runs ``scan(s, dev, xq_part, local_probes (nq, nprobe) int32,
    k)``, which returns max-oriented (scores, global storage positions).
    Returns the merged (scores, positions) (nq, k)."""
    npl = centroids.shape[0] // mesh.shape["shard"]
    cents = {}

    def scan_shard(s, dev, q, kk):
        if dev not in cents:
            cents[dev] = centroids.to(dev)
        probe = coarse_topk(q, cents[dev], nprobe, metric, metric_arg)
        local = probe - s * npl
        owned = (local >= 0) & (local < npl)
        local = torch.where(owned, local, npl).to(torch.int32).contiguous()
        return scan(s, dev, q, local, kk)

    return sharded_search(mesh, xq, k, scan_shard)


def sharded_graph_search(blocks: RowBlocks, graphs, nvalid, xq, k: int,
                         metric: str, **walk):
    """Sharded graph walk: shard s walks its subgraph ``graphs[s]``
    ({device: (rows, deg) int32 in local row indices}) over its row block,
    nodes past ``nvalid[s]`` never seeded (``walk``: graph_search's pool /
    width / iters / rerank).  Returns the merged max-oriented (scores,
    positions)."""
    from ..ops.graph import graph_search

    rows = blocks.rows

    def scan(s, dev, q, kk):
        if nvalid[s] == 0:
            return None
        sc, p = graph_search(blocks.block(s, dev), graphs[s][dev], q,
                             nvalid[s], min(kk, nvalid[s]), metric, **walk)
        return sc, offset_positions(p, s * rows)

    return sharded_search(blocks.mesh, xq, k, scan)


def sharded_kmeans_step(mesh: Mesh, x: torch.Tensor, valid: torch.Tensor,
                        centroids: torch.Tensor, spherical: bool = False):
    """One Lloyd iteration: the rows split over every device of the mesh
    (contiguous parts in grid order), each part assigned on its device,
    the centroid sums and counts added up on the centroids' device.
    ``valid`` (n,) bool weighs rows in or out.  Empty clusters keep their
    centroid; ``spherical`` renormalises (inner-product training)."""
    devs = list(mesh.devices.reshape(-1))
    home = centroids.device
    per = -(-x.shape[0] // len(devs))
    sums = torch.zeros_like(centroids)
    counts = torch.zeros(centroids.shape[0], dtype=torch.float32, device=home)
    cents = {}
    for i, dev in enumerate(devs):
        xs = x[i * per:(i + 1) * per].to(dev)
        if not xs.shape[0]:
            continue
        if dev not in cents:
            cents[dev] = centroids.to(dev)
        w = valid[i * per:(i + 1) * per].to(dev, torch.float32)
        labels = assign_labels(xs, cents[dev])
        sums += torch.zeros_like(cents[dev]).index_add_(
            0, labels, xs * w[:, None]).to(home)
        counts += torch.zeros(centroids.shape[0], dtype=torch.float32,
                              device=dev).index_add_(0, labels, w).to(home)
    new = sums / counts.clamp(min=1.0)[:, None]
    if spherical:
        new = new / new.norm(dim=1, keepdim=True).clamp(min=1e-20)
    return torch.where((counts > 0)[:, None], new, centroids)


def multichip_dryrun(n_devices: int) -> None:
    """Run every sharded path once at tiny shapes over an n_devices mesh of
    the local devices (repeated where there are fewer) and hold each
    against a numpy oracle (1e-3 relative and absolute, the JAX package's
    tolerance): the Flat scan, a k-means step, IVF,Flat, IVF-PQ with a
    selector mask, IVF,SQ8, the graph walk, row-placed PQ and SQ8 codes,
    and an LPT placement of deliberately skewed lists."""
    from ..ops.graph import build_graph
    from ..ops.ivf_list_scan import ivf_list_search
    from ..ops.ivf_pq_scan import ivf_pq_list_search
    from ..ops.ivf_sq_scan import ivf_sq_list_search
    from ..ops.pq import pq_decode, pq_search
    from ..ops.sq import (sq_decode, sq_pack, sq_quantize, sq_row_norms,
                          sq_row_sums, sq_search, sq_train)
    from ..utils.config import full_fp32
    from .placement import RowBlocks

    batch_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, batch_axis=batch_axis)
    n_shard = n_devices // batch_axis
    home = mesh.devices[0, 0]
    d, k = 32, 4
    cap = 64 * n_shard
    nq = 8 * batch_axis
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((cap, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    xq_t = torch.from_numpy(xq).to(home)
    close = dict(rtol=1e-3, atol=1e-3)

    def best_l2(rows, q, kk=k):
        return np.sort(((q[:, None, :] - rows[None]) ** 2).sum(-1), 1)[:, :kk]

    with full_fp32():
        # Flat rows over the shard axis, queries over the batch axis.
        blocks = RowBlocks(mesh, xb, home)
        s, p = sharded_flat_search(blocks, cap - 3, xq_t, k, "L2")
        np.testing.assert_allclose(-s.cpu().numpy(), best_l2(xb[:cap - 3],
                                                             xq), **close)
        assert int(p.max()) < cap - 3

        # One k-means step against the numpy Lloyd step.
        nclusters = 8
        cents = rng.standard_normal((nclusters, d)).astype(np.float32)
        lab = ((xb[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
        want = cents.copy()
        for c in range(nclusters):
            if (lab == c).any():
                want[c] = xb[lab == c].mean(0)
        got = sharded_kmeans_step(mesh, torch.from_numpy(xb).to(home),
                                  torch.ones(cap, dtype=torch.bool),
                                  torch.from_numpy(cents).to(home))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-5)

        # IVF: nlist lists of lmax slots, 16 live rows each, partitioned
        # over the shards; every probed list scanned by one shard.
        nlist, lmax, nprobe = 4 * n_shard, 128, 2
        counts = np.full((nlist,), 16, np.int32)
        lists = rng.standard_normal((nlist, lmax, d)).astype(np.float32)
        row_pos = np.arange(nlist * lmax, dtype=np.int32).reshape(nlist, lmax)
        row_pos[:, 16:] = -1
        cents = rng.standard_normal((nlist, d)).astype(np.float32)
        probes = np.argsort(((xq[:, None, :] - cents[None]) ** 2).sum(-1),
                            1, kind="stable")[:, :nprobe]

        def ivf_oracle(rows, perm=None, cnt=counts, keep=None):
            out = []
            for q in range(nq):
                cand = np.concatenate([rows[li, :cnt[li]] for li in probes[q]])
                ok = (np.ones(len(cand), bool) if keep is None else
                      np.concatenate([keep[li, :cnt[li]] for li in probes[q]]))
                out.append(best_l2(cand[ok], xq[q:q + 1])[0])
            return np.stack(out)

        def run_ivf(payload, perm, scan, cnt=counts, **extra):
            """The sharded IVF search over ``payload`` placed by ``perm``;
            ``scan(shard, sub-layout, queries, local probes, k)``."""
            subs = shard_lists(mesh, perm, payload, cnt, row_pos, cents,
                               **extra)
            s, p = sharded_ivf_search(
                mesh, torch.from_numpy(cents[perm]).to(home), xq_t,
                nprobe=nprobe, k=k, metric="L2",
                scan=lambda sh, dev, q, probe, kk: scan(sh, subs[sh][dev], q,
                                                        probe, kk))
            return -s.cpu().numpy(), p.cpu().numpy()

        ident = np.arange(nlist, dtype=np.int32)
        npl = nlist // n_shard
        got, _ = run_ivf(lists, ident, lambda sh, lay, q, probe, kk:
                         ivf_list_search(lay.payload, lay.counts, lay.row_pos,
                                         probe, q, None, k=kk, metric="L2"))
        np.testing.assert_allclose(got, ivf_oracle(lists), **close)

        # IVF-PQ with a per-(list, slot) selector mask (even rows pass).
        m, ksub = 4, 16
        codes = rng.integers(0, ksub, (nlist, lmax, m)).astype(np.uint8)
        cb = torch.from_numpy(rng.standard_normal(
            (m, ksub, d // m)).astype(np.float32))
        keep = (row_pos % 2 == 0) & (row_pos >= 0)
        masks = [torch.from_numpy(np.concatenate(
            [keep[sh * npl:(sh + 1) * npl], np.zeros((1, lmax), bool)])
            .astype(np.int8)) for sh in range(n_shard)]
        dec = (pq_decode(torch.from_numpy(codes.reshape(-1, m)), cb).numpy()
               .reshape(nlist, lmax, d) + cents[:, None, :])
        got, live = run_ivf(
            codes, ident, lambda sh, lay, q, probe, kk: ivf_pq_list_search(
                lay.payload, lay.counts, lay.row_pos, lay.codebooks,
                lay.centroids, probe, q, masks[sh].to(q.device), k=kk,
                metric="L2", codec="pq", row_terms=lay.rt),
            codebooks=cb, codec="pq", metric="L2")
        np.testing.assert_allclose(got, ivf_oracle(dec, keep=keep), **close)
        assert (live[live >= 0] % 2 == 0).all()

        # IVF,SQ8: int8 digit scan with the exact fp32 rerank (K2).
        flat_rows = torch.from_numpy(lists.reshape(-1, d))
        vmin, scale = sq_train(flat_rows, 256)
        q8 = sq_pack(sq_quantize(flat_rows, vmin, scale, 256).numpy(), "sq8")
        scale_np = scale.numpy()
        rn = sq_row_norms(q8, scale_np, d, "sq8").reshape(nlist, lmax)
        rs = sq_row_sums(q8, d, "sq8").reshape(nlist, lmax)
        got, _ = run_ivf(
            q8.reshape(nlist, lmax, -1), ident, lambda sh, lay, q, probe, kk:
            ivf_sq_list_search(lay.payload, lay.rn, lay.rs, lay.counts,
                               lay.row_pos, probe, q, None, vmin.to(q.device),
                               scale.to(q.device), k=kk, k_scan=4 * kk,
                               metric="L2", codec="sq8"),
            rn=rn, rs=rs)
        dec8 = sq_decode(torch.from_numpy(q8), vmin, scale,
                         "sq8").numpy().reshape(nlist, lmax, d)
        np.testing.assert_allclose(got, ivf_oracle(dec8), **close)

        # Graph walk: one CAGRA subgraph a shard in local row indices; a
        # pool of every shard's rows makes the walk exhaustive.
        rows = cap // n_shard
        graphs = []
        for sh in range(n_shard):
            blk = blocks.block(sh)
            adj = build_graph(blk, rows, 8, "L2")
            graphs.append({dev: adj.to(dev) for dev in mesh.shard_devices(sh)})
        s, p = sharded_graph_search(blocks, graphs, [rows] * n_shard, xq_t, k,
                                    "L2", pool=64, width=8, iters=12)
        np.testing.assert_allclose(-s.cpu().numpy(), best_l2(xb, xq), **close)

        # Row-placed PQ and SQ8 codes through their own scans.
        pq_codes = rng.integers(0, ksub, (cap, m)).astype(np.uint8)
        s, _ = sharded_rows_search(
            RowBlocks(mesh, pq_codes, home), cap - 3, xq_t, k,
            lambda sh, dev, blk, n, q, kk, msk: pq_search(
                blk, n, cb.to(dev), q, msk, 0.0, k=kk, metric="L2",
                chunk=blk.shape[0]))
        dec_pq = pq_decode(torch.from_numpy(pq_codes), cb).numpy()
        np.testing.assert_allclose(-s.cpu().numpy(),
                                   best_l2(dec_pq[:cap - 3], xq), **close)
        c8 = sq_pack(sq_quantize(torch.from_numpy(xb), vmin, scale,
                                 256).numpy(), "sq8")
        s, _ = sharded_rows_search(
            RowBlocks(mesh, c8, home), cap - 3, xq_t, k,
            lambda sh, dev, blk, n, q, kk, msk: sq_search(
                blk, n, vmin.to(dev), scale.to(dev), q, msk, k=kk,
                metric="L2", codec="sq8"))
        dec_sq = sq_decode(torch.from_numpy(c8), vmin, scale, "sq8").numpy()
        np.testing.assert_allclose(-s.cpu().numpy(),
                                   best_l2(dec_sq[:cap - 3], xq), **close)

        # Skew-aware placement: the hot lists packed first (a contiguous
        # split would park them all on shard 0), permuted by LPT.
        if n_shard > 1:
            cnt = np.full((nlist,), 4, np.int32)
            cnt[:nlist // n_shard] = lmax
            perm = balanced_list_partition(cnt, n_shard)
            loads = np.array([cnt[perm[i * npl:(i + 1) * npl]].sum()
                              for i in range(n_shard)], np.float64)
            contig = np.array([cnt[i * npl:(i + 1) * npl].sum()
                               for i in range(n_shard)], np.float64)
            assert loads.max() / loads.mean() < 1.3, loads
            assert loads.max() < contig.max(), (loads, contig)
            row_pos[:] = np.arange(nlist * lmax).reshape(nlist, lmax)
            row_pos[np.arange(lmax)[None, :] >= cnt[:, None]] = -1
            probes = np.argsort(((xq[:, None, :] - cents[None]) ** 2).sum(-1),
                                1, kind="stable")[:, :nprobe]
            got, _ = run_ivf(lists, perm, lambda sh, lay, q, probe, kk:
                             ivf_list_search(lay.payload, lay.counts,
                                             lay.row_pos, probe, q, None,
                                             k=kk, metric="L2"), cnt=cnt)
            np.testing.assert_allclose(got, ivf_oracle(lists, cnt=cnt),
                                       **close)
