"""IMI: IVF over a product (multi-index) coarse quantizer.

The counterpart of ``duckdb_faiss_ext_tpu/models/imi.py``: the factory's
``IMI2x{nbits}[,encoding]`` heads (faiss::MultiIndexQuantizer feeding
IndexIVF*, reachable through the reference's pass-through factory call,
src/faiss_extension.cpp:154-155).

The coarse space is the cross product of two codebooks of K = 2^nbits
centroids fitted independently on the two halves of the vector (two
k-means runs on the index's device, seeds ``train_seed`` and
``train_seed + 1``), giving nlist = K² cells while training needs only
n ≥ K points.  The (K², d) cell table is materialized once at train time
(capped at ``MAX_TABLE_BYTES``), so every IVF layout, scan and kernel
(K6 / K7, K2 / K3, K8) serves it unchanged and probing is one distance
tile against the table.  Assignment stays factored per half, exact for L2
and inner product because both decompose over disjoint coordinate blocks,
in fp32 (``full_fp32``).  Device-resident ingest is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..ops.distance import pairwise_tile
from ..ops.flat_search import SIMILARITY_METRICS
from ..ops.kmeans import kmeans_fit
from ..utils.config import full_fp32
from .base import Index
from .ivf import IVFIndex


class IMIIndex(IVFIndex):
    #: materialized cell-table cap (bytes): 4^nbits · d · 4
    MAX_TABLE_BYTES = 1 << 30
    _mirror_quantizer = False
    _supports_device_ingest = False
    UNPADDED_FLAT = False

    def __init__(self, d: int, metric: Metric, metric_arg: float,
                 nbits: int, quantizer: Index, encoding: str = "Flat"):
        nbits = int(nbits)
        if nbits < 1:
            raise errors.InvalidInputError(
                f"IMI needs at least 1 bit per sub-quantizer, got {nbits}")
        if d % 2:
            raise errors.InvalidInputError(
                f"The dimension of the vector ({d}) must be even for an "
                f"IMI2x coarse quantizer")
        table_bytes = (1 << (2 * nbits)) * d * 4
        if table_bytes > self.MAX_TABLE_BYTES:
            raise errors.InvalidInputError(
                f"IMI2x{nbits} at dimension {d} needs a "
                f"{table_bytes >> 20} MiB cell table (cap "
                f"{self.MAX_TABLE_BYTES >> 20} MiB); use fewer bits")
        super().__init__(d, metric, metric_arg, nlist=1 << (2 * nbits),
                         quantizer=quantizer, encoding=encoding)
        if metric.name not in ("L2", "INNER_PRODUCT"):
            raise errors.InvalidInputError(
                f"IMI indexes support only L2 and INNER_PRODUCT metrics, "
                f"got {metric.name}")
        self.imi_nbits = nbits

    def _train_coarse(self, x):
        K = 1 << self.imi_nbits
        x = self._subsample_train(x, K)
        h = self.d // 2
        xd = self._on_device(x)
        cb1, _ = kmeans_fit(xd[:, :h].contiguous(), K, niter=self.train_niter,
                            seed=self.train_seed, balance=self.train_balance)
        cb2, _ = kmeans_fit(xd[:, h:].contiguous(), K, niter=self.train_niter,
                            seed=self.train_seed + 1,
                            balance=self.train_balance)
        # Cell (i, j) → list i·K + j, centre concat(cb1[i], cb2[j]).
        table = torch.cat([cb1.repeat_interleave(K, 0), cb2.repeat(K, 1)], 1)
        return table.cpu().numpy().astype(np.float32), x

    def _imi_codebooks(self):
        """The factored sub-codebooks, recovered from the cell table."""
        K = 1 << self.imi_nbits
        h = self.d // 2
        return self._centroids[::K, :h], self._centroids[:K, h:]

    def _assign_lists(self, x) -> np.ndarray:
        """Exact factored assignment: the per-half best sub-centroid.  The
        cell score is the sum of the two half scores over disjoint
        coordinates, so the per-half best is the best of all K² cells."""
        if x.shape[0] == 0:
            return np.empty((0,), dtype=np.int32)
        K = 1 << self.imi_nbits
        h = self.d // 2
        cb1, cb2 = (torch.from_numpy(np.ascontiguousarray(c)).to(self.device)
                    for c in self._imi_codebooks())
        sim = self.metric.name in SIMILARITY_METRICS
        chunk = max(1024, min(65536, (1 << 27) // K))
        out = torch.empty((x.shape[0],), dtype=torch.int32,
                          device=self.device)
        with full_fp32():
            for i in range(0, x.shape[0], chunk):
                xc = self._on_device(x[i:i + chunk])
                best = []
                for half, cb in ((xc[:, :h], cb1), (xc[:, h:], cb2)):
                    t = pairwise_tile(half.contiguous(), cb, self.metric.name,
                                      self.metric_arg)
                    best.append(t.argmax(1) if sim else t.argmin(1))
                out[i:i + chunk] = (best[0] * K + best[1]).to(torch.int32)
        return out.cpu().numpy()
