"""Device-sharded IVF placement: the faiss_to_gpu analogue for IVF.

The counterpart of ``duckdb_faiss_ext_tpu/models/ivf_sharded.py``
(``shard_over``, ``_build_sharded``, ``_ivf_sharded_mask``,
``_search_sharded``).  ``shard_over(mesh)`` partitions the padded list
layout over the mesh's 'shard' axis: the host layout is built with no list
cap (so no spill), its lists are put in the LPT order of
``parallel.sharded.balanced_list_partition`` (kept as ``_shard_perm``) so
each shard's Σcounts is balanced, and shard s gets the lists
``perm[s·npl:(s+1)·npl]`` plus one empty list (``shard_lists``).  A search
takes the coarse top-nprobe on the permuted centroids, and every shard runs
the index's own list search on its lists (``IVFServe._list_search``: K6 /
K7 / K10 for Flat, K2 / K3 / K9 for SQ on the int8 path, K8 for PQ / RQ),
or, where the single-device index has no kernel path (SQ in parity mode,
the float codecs, PQ / RQ with k above K8's limit), the plain decode scan
over the same sub-layout; then the shards merge.  Row positions in the
sub-layouts stay global storage rows, so labels, SOAR's duplicate drop and
the selector masks need no translation.  Masks are built per shard on its
device through ``ops.selectors.device_row_mask``.

The placement is sticky across adds (the sharded layout is rebuilt on the
same mesh after a mutation) and is not saved: a loaded index comes back
unplaced, as in the JAX package.  This covers IMI (its cell table is the
centroid table) and SOAR.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..ops.flat_search import finalize_scores
from ..ops.ivf_pq_scan import MAX_K as PQ_MAX_K
from ..ops.ivf_scan import choose_q_chunk, ivf_pq_search, ivf_search, \
    ivf_sq_search
from ..ops.sq import FLOAT_CODECS
from ..utils.config import sq_int8_active


class IVFSharded:
    """Placement methods of ``models.ivf.IVFIndex``."""

    def shard_over(self, mesh) -> None:
        """Partition the lists over the mesh's 'shard' axis (each shard a
        group of nlist / S lists); the shard count shrinks to the largest
        divisor of nlist that fits."""
        from ..parallel.placement import Mesh

        if self.metric.name not in ("L2", "INNER_PRODUCT"):
            raise errors.InvalidInputError(
                f"IVF indexes with metric {self.metric.name} cannot be "
                f"sharded over devices (only L2 and INNER_PRODUCT)")
        if self._dr is not None:
            raise errors.InvalidInputError(
                "a device-resident index cannot be re-sharded with "
                "faiss_to_device (its layout lives on one device)")
        if "batch" not in mesh.shape or "shard" not in mesh.shape:
            raise errors.InvalidInputError(
                "IVF sharding needs a mesh with 'shard' and 'batch' axes "
                "(parallel.placement.default_mesh builds one)")
        nshards = int(mesh.shape["shard"])
        if self.nlist % nshards:
            usable = next(g for g in range(min(nshards, self.nlist), 0, -1)
                          if self.nlist % g == 0)
            mesh = Mesh([[d] for d in mesh.devices.reshape(-1)[:usable]])
        self._shard_mesh = mesh
        self._sharded_cache = None
        self._mask_cache.clear()

    def _build_sharded(self):
        """(permuted centroids on the index's device, per-shard {device:
        ListLayout}, lmax), built once per mutation."""
        from ..parallel.sharded import balanced_list_partition, shard_lists

        if self._sharded_cache is not None:
            return self._sharded_cache
        mesh = self._shard_mesh
        payload, counts, row_pos, _ = self._build_list_layout()
        perm = balanced_list_partition(counts, mesh.shape["shard"])
        self._shard_perm = perm
        rn = rs = None
        if self.sq_type is not None and self.sq_type not in FLOAT_CODECS:
            # Σ(scale·c)² and Σc of every slot (K2 / K3 read them).
            rn_rows, rs_rows = self._sq_row_extras()
            valid = row_pos >= 0
            rn = np.zeros(row_pos.shape, np.float32)
            rs = np.zeros(row_pos.shape, np.float32)
            rn[valid] = rn_rows[row_pos[valid]]
            rs[valid] = rs_rows[row_pos[valid]]
        codebooks = (torch.from_numpy(self._pq_codebooks)
                     if self.pq_m is not None else None)
        layouts = shard_lists(mesh, perm, payload, counts, row_pos,
                              self._centroids, rn=rn, rs=rs,
                              codebooks=codebooks, codec=self.pq_codec,
                              metric=self.metric.name)
        cents = torch.from_numpy(self._centroids[perm]).to(self.device)
        self._sharded_cache = (cents, layouts, payload.shape[1])
        return self._sharded_cache

    def _ivf_sharded_mask(self, selector):
        """Per shard {device: (npl + 1, lmax) int8 mask} over the shard's
        sub-layout, built on its device."""
        def build():
            return [{dev: self._row_mask(selector, lay.row_pos)
                     for dev, lay in per_dev.items()}
                    for per_dev in self._build_sharded()[1]]

        return self._cached_mask(("sharded", selector.cache_key()), build)

    def _shard_kernels(self, k: int) -> bool:
        """Whether a shard's search takes the list kernels (as the
        single-device index's layout path would) or the decode scan."""
        if self.sq_type is not None:
            return self.sq_type not in FLOAT_CODECS and sq_int8_active()
        return self.pq_m is None or k <= PQ_MAX_K

    def _search_sharded(self, xq_pad, nq, k, nprobe, selector):
        """The sharded search as a ``Dispatch``."""
        from ..parallel.sharded import sharded_ivf_search

        cents, layouts, lmax = self._build_sharded()
        k_eff = min(k, nprobe * lmax)
        masks = (self._ivf_sharded_mask(selector) if selector is not None
                 else None)
        kernels = self._shard_kernels(k_eff)

        def scan(s, dev, q, probe, kk):
            lay = layouts[s][dev]
            mask = masks[s][dev] if masks is not None else None
            if kernels:
                return self._list_search(lay, q, probe, kk, mask)
            return self._shard_decode_scan(lay, q, probe, kk, mask)

        scores, pos = sharded_ivf_search(
            self._shard_mesh, cents, xq_pad, nprobe=nprobe, k=k_eff,
            metric=self.metric.name, metric_arg=self.metric_arg, scan=scan)
        dist, pos = finalize_scores(scores, pos, self.metric.name)
        return self._as_dispatch(dist, pos, nq, k_eff)

    def _shard_decode_scan(self, lay, xq, probe, k, mask):
        """The plain decode scan (``ops.ivf_scan``) over a shard's padded
        sub-layout read as a row-sorted buffer (list l at rows l·lmax),
        positions mapped through its row positions."""
        nl, lmax, w = lay.payload.shape
        dev = lay.payload.device
        offsets = torch.arange(nl, dtype=torch.int32, device=dev) * lmax
        flat_mask = mask.reshape(-1).bool() if mask is not None else None
        common = dict(k=k, nprobe=probe.shape[1], metric=self.metric.name,
                      q_chunk=choose_q_chunk(xq.shape[0],
                                             probe.shape[1] * lmax, self.d),
                      lmax=lmax, probe_ids=probe)
        args = (offsets, lay.counts, lay.centroids, xq, flat_mask,
                self.metric_arg)
        buf = lay.payload.reshape(-1, w)
        if self.sq_type is not None:
            scores, slot = ivf_sq_search(buf, *self._sq_ranges(dev), *args,
                                         codec=self.sq_type, **common)
        elif self.pq_m is not None:
            scores, slot = ivf_pq_search(buf, lay.codebooks, *args,
                                         codec=self.pq_codec, **common)
        else:
            scores, slot = ivf_search(buf, *args, **common)
        pos = lay.row_pos.reshape(-1)[slot.clamp(min=0).long()]
        return scores, torch.where(slot >= 0, pos, -1)
