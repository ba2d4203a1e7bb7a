"""Residual-quantizer index (faiss::IndexResidualQuantizer surface).

The counterpart of ``duckdb_faiss_ext_tpu/models/rq.py``: factory strings
``RQ{M}x{b}`` (the reference's verbatim index_factory pass-through,
src/faiss_extension.cpp:154-155).  It shares PQIndex's whole execution
shape (uint8 codes on the device, the fused decode + distance + top-k scan,
whose ``codec`` switch selects the additive decoder); only the codec's
training and encoding differ: full-dimension stage codebooks whose codewords
sum to the reconstruction, encoded with a batched beam search (``beam``
create parameter; the state key ``rq_meta`` holds it).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..ops.rq import rq_encode, rq_train
from .base import Index
from .pq import PQIndex

#: beam width of the encoder (the JAX package's models/rq.DEFAULT_BEAM)
DEFAULT_BEAM = 4


class RQIndex(PQIndex):
    codec = "rq"

    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 M: int = 8, nbits: int = 8):
        # No d % M rule: RQ stages are full-dimension.
        if metric.name not in ("L2", "INNER_PRODUCT"):
            raise errors.InvalidInputError(
                f"RQ indexes support only L2 and INNER_PRODUCT metrics, "
                f"got {metric.name}")
        if not 1 <= int(nbits) <= 8:
            # One uint8 per stage; more bits would wrap the beam's picks.
            raise errors.InvalidInputError(
                f"RQ supports 1-8 bits per stage (uint8 code storage), "
                f"got {nbits}")
        Index.__init__(self, d, metric, metric_arg)
        self._init_storage(M, nbits)
        self.beam = DEFAULT_BEAM

    def apply_create_params(self, params) -> None:
        if params.get_float("anisotropic_eta") is not None:
            raise errors.InvalidInputError(
                "anisotropic_eta applies to PQ codebooks only (the RQ "
                "encoder has no score-aware variant yet)")
        b = params.get_int("beam")
        if b is not None:
            self.beam = max(1, b)

    def _train_codebooks(self, x: torch.Tensor) -> torch.Tensor:
        return rq_train(x, self.M, self.ksub, seed=self.train_seed)

    def _encode(self, x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        return rq_encode(x, cb, beam=self.beam)

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["rq_meta"] = np.array([self.beam])
        return state

    def load_state(self, state: dict) -> None:
        meta = state.get("rq_meta")
        if meta is not None:
            self.beam = int(np.asarray(meta).reshape(-1)[0])
        super().load_state(state)
