"""PQ index: trained codebooks + uint8 codes, fused decode-scan search.

The counterpart of ``duckdb_faiss_ext_tpu/models/pq.py`` (faiss::IndexPQ,
factory ``PQm[xb]``; SearchParametersPQ defaults,
src/faiss_extension.cpp:704-708).  Like FAISS, only the codes are stored;
``reconstruct`` returns the decoded approximation.  Metrics: L2 and
INNER_PRODUCT.

State (the checkpoint both packages share): ``codes`` (n, M) uint8 in
insertion order on the host, the trained ``codebooks`` and, when the
``anisotropic_eta`` create parameter is above 1, ``aniso_eta``.  Codebooks
are trained and rows encoded on the index's device; the codes and codebooks
go to the device once per mutation (codes padded to a capacity bucket), and
a search is ``ops/pq.pq_search`` over them (plain torch: the JAX package
ran it as XLA, with no Pallas kernel).

``range_search`` thresholds dense tiles of decoded code chunks on the
device (ops/range.py).  ``shard_over`` (faiss_to_device) places the codes
over a mesh as row blocks (parallel/placement.py; sticky across train and
add, so it may come before training): each shard runs ``pq_search`` on its
block and the shards merge (parallel/sharded.py).  RQIndex inherits it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..ops.flat_search import finalize_scores
from ..ops.kmeans import DEFAULT_SEED
from ..ops.pq import (codec_decode, pq_encode, pq_encode_anisotropic,
                      pq_search, pq_train, pq_train_anisotropic)
from ..params import EMPTY
from ..parallel.sharded import sharded_rows_search
from ..utils.config import (config, next_capacity, next_pow2, pad_rows,
                            resolve_device)
from ..utils.transfer import upload_queries
from .base import (Index, SearchResult, as_matrix, placement_capacity,
                   row_placement)

#: rows a chunk of the device-side encoding takes
ENCODE_CHUNK = 1 << 18


def not_trained() -> errors.InvalidInputError:
    return errors.InvalidInputError(
        "Index is not trained; call train (or faiss_manual_train) before "
        "adding or searching")


class PQIndex(Index):
    #: decoder of the stored byte codes: "pq" (subspace concat) or "rq"
    #: (additive sum; RQIndex)
    codec = "pq"

    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 M: int = 8, nbits: int = 8):
        super().__init__(d, metric, metric_arg)
        if d % M != 0:
            raise errors.InvalidInputError(
                f"The dimension of the vector ({d}) must be a multiple of "
                f"the number of subquantizers ({M})")
        if metric.name not in ("L2", "INNER_PRODUCT"):
            raise errors.InvalidInputError(
                f"PQ indexes support only L2 and INNER_PRODUCT metrics, "
                f"got {metric.name}")
        self._init_storage(M, nbits)

    def _init_storage(self, M: int, nbits: int) -> None:
        #: where the codes live and searches run
        self.device = resolve_device()
        self.M = int(M)
        self.nbits = int(nbits)
        self.ksub = 1 << int(nbits)
        #: ScaNN-style score-aware loss weight (anisotropic_eta create
        #: param): > 1 weights the score-shifting parallel residual more in
        #: training AND encoding; 1.0 is plain k-means / nearest.
        self.aniso_eta = 1.0
        self.train_seed = DEFAULT_SEED
        self._codebooks: np.ndarray | None = None
        self._codes = np.empty((0, self.M), dtype=np.uint8)
        self._version = 0
        #: sticky row placement set by faiss_to_device, or None
        self._placement = None
        self._invalidate()

    @property
    def ntotal(self) -> int:
        return self._codes.shape[0]

    @property
    def is_trained(self) -> bool:
        return self._codebooks is not None

    @property
    def requires_training(self) -> bool:
        return True

    def apply_create_params(self, params) -> None:
        eta = params.get_float("anisotropic_eta")
        if eta is not None:
            if eta < 1.0:
                raise errors.InvalidInputError(
                    f"anisotropic_eta must be >= 1.0, got {eta}")
            self.aniso_eta = eta

    # --- codec hooks (RQIndex overrides) ------------------------------------
    def _train_codebooks(self, x: torch.Tensor) -> torch.Tensor:
        if self.aniso_eta > 1.0:
            return pq_train_anisotropic(x, self.M, self.ksub, self.aniso_eta,
                                        seed=self.train_seed)
        return pq_train(x, self.M, self.ksub, seed=self.train_seed)

    def _encode(self, x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        if self.aniso_eta > 1.0:
            return pq_encode_anisotropic(x, cb, self.aniso_eta)
        return pq_encode(x, cb)

    # --- lifecycle ---------------------------------------------------------
    def train(self, x) -> None:
        if self.is_trained:
            return
        x = as_matrix(x, self.d)
        if x.shape[0] < self.ksub:
            raise errors.TrainingTooSmallError(x.shape[0], self.ksub)
        cb = self._train_codebooks(torch.from_numpy(x).to(self.device))
        self._codebooks = cb.cpu().numpy().astype(np.float32)
        self._invalidate()

    def add(self, x) -> None:
        if not self.is_trained:
            raise not_trained()
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
        cb = torch.from_numpy(self._codebooks).to(self.device)
        codes = np.concatenate([
            self._encode(torch.from_numpy(x[i:i + ENCODE_CHUNK]).to(
                self.device), cb).cpu().numpy()
            for i in range(0, x.shape[0], ENCODE_CHUNK)])
        self._codes = np.concatenate([self._codes, codes], axis=0)
        self._invalidate()

    def reconstruct(self, key: int) -> np.ndarray:
        return codec_decode(torch.from_numpy(self._codes[key:key + 1]),
                            torch.from_numpy(self._codebooks),
                            self.codec)[0].numpy()

    def _invalidate(self) -> None:
        self._version += 1
        self._device_state_cache = None
        self._mask_cache: dict = {}

    def _device_state(self):
        """(codes (cap, M) uint8, codebooks) on the index's device, the codes
        padded to a capacity bucket (RowBlocks under a placement); uploaded
        once per mutation."""
        if self._device_state_cache is None:
            cap = placement_capacity(
                max(config.min_capacity, next_capacity(max(self.ntotal, 1))),
                self._placement)
            codes = pad_rows(self._codes, cap)
            self._device_state_cache = (
                self._placement.place(codes, self.device)
                if self._placement is not None
                else torch.from_numpy(codes).to(self.device),
                torch.from_numpy(self._codebooks).to(self.device))
        return self._device_state_cache

    def shard_over(self, mesh) -> None:
        """faiss_to_gpu analogue: the codes row-placed over the mesh, the
        codebooks on every shard's device; an untrained index keeps the
        placement until its codes exist."""
        self._placement = row_placement(mesh)
        self._invalidate()
        if self.is_trained:
            self._device_state()

    # --- search --------------------------------------------------------------
    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        return self._finish_dispatch(
            self.search_dispatch(xq, k, params, selector), xq, k)

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """Device dispatch without the host fetch: (dist, pos, nq, k_eff) or
        None when no device work applies (empty queries, k ≤ 0)."""
        if not self.is_trained:
            raise not_trained()
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        k = int(k)
        if nq == 0 or k <= 0:
            return None
        codes_dev, cb_dev = self._device_state()
        cap = codes_dev.shape[0]
        k_eff = min(k, cap)
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        xq_pad = upload_queries(pad_rows(xq, nq_pad), self.device)
        mask = None
        if selector is not None:
            key = (selector.cache_key(), self._version)
            mask = self._mask_cache.get(key)
            if mask is None:
                rows = selector.contains(self.row_labels())
                mask = torch.from_numpy(pad_rows(rows, cap, fill=False)).to(
                    self.device)
                self._mask_cache = {key: mask}
        # The (nq, chunk) score tile and the (chunk, d) decoded rows stay
        # under 2^26 values; results do not depend on the chunk.
        chunk = next_pow2(max(1024, (1 << 26) // max(nq_pad, self.d)))

        def search(codes, n, xq, k, mask, cb):
            return pq_search(codes, n, cb, xq, mask, self.metric_arg, k=k,
                             metric=self.metric.name,
                             chunk=min(codes.shape[0], chunk),
                             codec=self.codec)

        if self._placement is not None:
            scores, pos = sharded_rows_search(
                codes_dev, self.ntotal, xq_pad, k_eff,
                lambda s, dev, blk, n, q, kk, m: search(blk, n, q, kk, m,
                                                        cb_dev.to(dev)),
                mask)
        else:
            scores, pos = search(codes_dev, self.ntotal, xq_pad, k_eff, mask,
                                 cb_dev)
        dist, pos = finalize_scores(scores, pos, self.metric.name)
        return dist, pos, nq, k_eff

    def range_search(self, xq, radius, params=None, selector=None):
        """Dense tiles of decoded code chunks, thresholded on the device
        (ops/range.py); RQIndex inherits it with its additive decoder."""
        from ..ops.range import dense_range_search

        if not self.is_trained:
            raise not_trained()
        codes_dev, cb_dev = self._device_state()
        return dense_range_search(
            self, xq, radius, selector, codes_dev,
            lambda c: codec_decode(c, cb_dev, self.codec))

    # --- serialization -------------------------------------------------------
    def state_dict(self) -> dict:
        state = {"codes": self._codes}
        if self._codebooks is not None:
            state["codebooks"] = self._codebooks
        if self.aniso_eta > 1.0:
            state["aniso_eta"] = np.float32(self.aniso_eta)
        return state

    def load_state(self, state: dict) -> None:
        eta = state.get("aniso_eta")
        if eta is not None:
            self.aniso_eta = float(eta)
        # Copies: arrays carried from the JAX package are read-only.
        self._codes = np.array(state["codes"], np.uint8).reshape(-1, self.M)
        cb = state.get("codebooks")
        self._codebooks = (np.array(cb, np.float32)
                           if cb is not None else None)
        self._invalidate()
