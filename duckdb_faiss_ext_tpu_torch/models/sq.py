"""Scalar-quantizer index: SQ8, SQ4, SQ6, SQfp16 and SQbf16.

The counterpart of ``duckdb_faiss_ext_tpu/models/sq.py``
(faiss::IndexScalarQuantizer, factory ``SQ8`` / ``SQ4`` / ``SQ6`` /
``SQfp16`` / ``SQbf16``).  The quantized types train per-dimension ranges
(min / max, so bit-equal to the JAX package's from the same rows); the
float codecs need no training.  Only the codes are stored: SQ4 / SQ6
bit-packed, the float codecs as the bytes of their half-width rows
(ops/sq.py).

State (the checkpoint both packages share): ``codes`` (n, w) uint8 in
insertion order on the host and, once trained, ``vmin`` / ``scale``.  Rows
are quantized on the index's device; the codes go to the device once per
mutation, padded to a capacity bucket.  A search decodes chunks of them
into the fp32 distance tile (``ops/sq.sq_search``, every metric), or, for
the quantized codecs under L2 / inner product at d ≥ 16 while the int8
path is active (``utils.config.sq_int8_active``: fast mode, or
``set_sq_dot("int8")``), scores them by exact int8 digit dots and rescores
the best ``k_scan`` rows in fp32 (``ops/sq.sq_int8_search``).  Both are
plain torch: the JAX package ran them as XLA, with no Pallas kernel.

``range_search`` decodes chunks of the codes into dense tiles thresholded
on the device (ops/range.py).  ``shard_over`` (faiss_to_device) places the
codes (and the int8 path's per-row sums) over a mesh as row blocks
(parallel/placement.py; sticky across train and add): each shard runs the
same scan on its block and the shards merge (parallel/sharded.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..ops.flat_search import finalize_scores
from ..ops.sq import (FLOAT_CODECS, SQ_LEVELS, float_encode, sq_code_width,
                      sq_decode, sq_int8_search, sq_pack, sq_quantize,
                      sq_ranges, sq_row_norms, sq_row_sums, sq_search,
                      sq_train)
from ..params import EMPTY
from ..parallel.sharded import sharded_rows_search
from ..utils.config import (config, next_capacity, next_pow2, pad_rows,
                            resolve_device, sq_int8_active)
from ..utils.transfer import upload_queries
from .base import (Index, SearchResult, as_matrix, placement_capacity,
                   row_placement)
from .pq import not_trained

#: the factory's scalar-quantizer types
SQ_TYPES = ("SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16")

#: rows a chunk of the device-side quantization takes
ENCODE_CHUNK = 1 << 18


class SQIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 qtype: str = "SQ8"):
        super().__init__(d, metric, metric_arg)
        if qtype not in SQ_TYPES:
            raise errors.InvalidInputError(
                f"Scalar quantizer type {qtype} is not supported "
                f"(use SQ8, SQ4, SQ6, SQfp16 or SQbf16)")
        #: where the codes live and searches run
        self.device = resolve_device()
        #: sticky row placement set by faiss_to_device, or None
        self._placement = None
        self.qtype = qtype
        #: "sq8" | "sq4" | "sq6" | "fp16" | "bf16"
        self.codec = qtype[2:] if qtype[2:] in FLOAT_CODECS else qtype.lower()
        self._vmin: np.ndarray | None = None
        self._scale: np.ndarray | None = None
        self._codes = np.empty((0, sq_code_width(d, self.codec)), np.uint8)
        self._version = 0
        self._invalidate()

    @property
    def ntotal(self) -> int:
        return self._codes.shape[0]

    @property
    def is_trained(self) -> bool:
        return self.codec in FLOAT_CODECS or self._vmin is not None

    @property
    def requires_training(self) -> bool:
        return self.codec not in FLOAT_CODECS

    # --- lifecycle ---------------------------------------------------------
    def train(self, x) -> None:
        if self.is_trained:
            return
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            raise errors.TrainingTooSmallError(0, 1)
        vmin, scale = sq_train(torch.from_numpy(x).to(self.device),
                               SQ_LEVELS[self.codec])
        self._vmin = vmin.cpu().numpy()
        self._scale = scale.cpu().numpy()
        self._invalidate()

    def add(self, x) -> None:
        if not self.is_trained:
            raise not_trained()
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
        if self.codec in FLOAT_CODECS:
            codes = float_encode(torch.from_numpy(x), self.codec).numpy()
        else:
            vmin, scale = self._ranges()
            q = np.concatenate([
                sq_quantize(torch.from_numpy(x[i:i + ENCODE_CHUNK]).to(
                    self.device), vmin, scale, SQ_LEVELS[self.codec])
                .cpu().numpy()
                for i in range(0, x.shape[0], ENCODE_CHUNK)])
            codes = sq_pack(q, self.codec)
        self._codes = np.concatenate([self._codes, codes], axis=0)
        self._invalidate()

    def reconstruct(self, key: int) -> np.ndarray:
        vmin, scale = self._ranges("cpu")
        return sq_decode(torch.from_numpy(self._codes[key:key + 1]), vmin,
                         scale, self.codec)[0].numpy()

    def range_search(self, xq, radius, params=None, selector=None):
        """Dense tiles of decoded code chunks, thresholded on the device
        (ops/range.py)."""
        from ..ops.range import dense_range_search

        if not self.is_trained:
            raise not_trained()
        codes, vmin, scale = self._device_state()
        return dense_range_search(
            self, xq, radius, selector, codes,
            lambda c: sq_decode(c, vmin, scale, self.codec))

    # --- device state ---------------------------------------------------------
    def _invalidate(self) -> None:
        self._version += 1
        self._device_state_cache = None
        self._int8_rows_cache = None
        self._mask_cache: dict = {}

    def _capacity(self) -> int:
        return placement_capacity(
            max(config.min_capacity, next_capacity(max(self.ntotal, 1))),
            self._placement)

    def _upload(self, host: np.ndarray):
        """A padded host array on the index's device, or as RowBlocks under
        a placement."""
        if self._placement is not None:
            return self._placement.place(host, self.device)
        return torch.from_numpy(host).to(self.device)

    def shard_over(self, mesh) -> None:
        """faiss_to_gpu analogue: the codes row-placed over the mesh, the
        ranges on every shard's device; an untrained index keeps the
        placement until its codes exist."""
        self._placement = row_placement(mesh)
        self._invalidate()
        if self.is_trained:
            self._device_state()

    def _ranges(self, device=None):
        """(vmin, scale) (d,) fp32 on ``device`` (the index's by default)."""
        return sq_ranges(self._vmin, self._scale, self.d,
                         self.device if device is None else device)

    def _device_state(self):
        """(codes (cap, w) uint8, vmin, scale) on the index's device, the
        codes padded to a capacity bucket; uploaded once per mutation."""
        if self._device_state_cache is None:
            self._device_state_cache = (
                self._upload(pad_rows(self._codes, self._capacity())),
                *self._ranges())
        return self._device_state_cache

    def _int8_rows(self):
        """(Σ(scale·c)², Σc) (cap,) fp32 of every row on the index's device,
        the int8 scan's only state beside the codes it shares with the
        decode path."""
        if self._int8_rows_cache is None:
            cap = self._capacity()
            self._int8_rows_cache = tuple(
                self._upload(pad_rows(a, cap))
                for a in (sq_row_norms(self._codes, self._scale, self.d,
                                       self.codec),
                          sq_row_sums(self._codes, self.d, self.codec)))
        return self._int8_rows_cache

    def int8_serves(self) -> bool:
        """Whether a search now takes the int8 digit-dot scan: a quantized
        codec, L2 or inner product, d ≥ 16 (below it the margins sit at the
        int8 noise floor), and the int8 path active."""
        return (self.codec in SQ_LEVELS
                and self.metric.name in ("L2", "INNER_PRODUCT")
                and self.d >= 16 and sq_int8_active())

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
        codes, vmin, scale = self._device_state()
        cap = codes.shape[0]
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
        int8 = self.int8_serves()
        rn, rs = self._int8_rows() if int8 else (None, None)

        def search(codes, rn, rs, n, xq, k, mask, vmin, scale):
            if int8:
                return sq_int8_search(
                    codes, rn, rs, n, vmin, scale, xq, mask, k=k,
                    k_scan=min(codes.shape[0], max(4 * k, k + 32)),
                    metric=self.metric.name, codec=self.codec)
            return sq_search(codes, n, vmin, scale, xq, mask,
                             self.metric_arg, k=k, metric=self.metric.name,
                             codec=self.codec)

        if self._placement is not None:
            def block(s, dev, blk, n, q, kk, m):
                return search(blk, None if rn is None else rn.block(s, dev),
                              None if rs is None else rs.block(s, dev), n, q,
                              kk, m, vmin.to(dev), scale.to(dev))

            scores, pos = sharded_rows_search(codes, self.ntotal, xq_pad,
                                              k_eff, block, mask)
        else:
            scores, pos = search(codes, rn, rs, self.ntotal, xq_pad, k_eff,
                                 mask, vmin, scale)
        dist, pos = finalize_scores(scores, pos, self.metric.name)
        return dist, pos, nq, k_eff

    # --- serialization -------------------------------------------------------
    def state_dict(self) -> dict:
        state = {"codes": self._codes}
        if self._vmin is not None:
            state["vmin"] = self._vmin
            state["scale"] = self._scale
        return state

    def load_state(self, state: dict) -> None:
        # Copies: arrays carried from the JAX package are read-only.
        self._codes = np.array(state["codes"], np.uint8).reshape(
            -1, sq_code_width(self.d, self.codec))
        vmin = state.get("vmin")
        if vmin is not None:
            self._vmin = np.array(vmin, np.float32).reshape(-1)
            self._scale = np.array(state["scale"], np.float32).reshape(-1)
        self._invalidate()
