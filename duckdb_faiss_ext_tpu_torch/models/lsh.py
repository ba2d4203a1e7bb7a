"""LSH index: sign-random-projection binary codes, exact Hamming search.

The counterpart of ``duckdb_faiss_ext_tpu/models/lsh.py``
(faiss::IndexLSH, factory ``LSH`` / ``LSHr`` / ``LSHt`` / ``LSHrt``,
reachable through the reference's pass-through factory call,
src/faiss_extension.cpp:154-155).  Semantics mirrored: ``nbits`` defaults
to ``d``; the ``r`` suffix applies a random rotation before binarization
(``ROTATION_SEED``, persisted in the checkpoint); the ``t`` suffix trains
per-bit thresholds (making the index require training); distances are
Hamming counts as float32; the metric is ignored (IndexLSH always ranks by
Hamming distance, so L2 ordering is forced).  An explicit bit count
(``LSH64``) is accepted, as in the JAX package.

Codes are ±1 rows stored int8 in an inner inner-product ``FlatIndex``
(``storage="pm1_i8"``), because for ±1 vectors hamming(a, b) = (nbits −
a·b) / 2: the search is the exact int32 dot and top-k of
``ops.flat_search.pm1_search`` (``torch._int_mm`` on the card), then one
affine map on the device.  Rows and queries are encoded on the host in
numpy, as in the JAX package, so both packages give the same bits.  No
range search (FAISS has none for IndexLSH).
"""

from __future__ import annotations

import numpy as np

from .. import errors
from ..metrics import Metric, resolve_metric
from ..params import EMPTY
from .base import Index, as_matrix, row_placement
from .flat import FlatIndex

#: seed of the random rotation (deterministic per (d, nbits), so factory
#: rebuilds agree; the rotation is also persisted in the checkpoint)
ROTATION_SEED = 1234


def _not_trained() -> errors.InvalidInputError:
    return errors.InvalidInputError(
        "Index is not trained; call train (or faiss_manual_train) "
        "before adding or searching")


class LSHIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 nbits: int | None = None, rotate: bool = False,
                 train_thresholds: bool = False):
        # IndexLSH has no metric: results are Hamming distances, ascending,
        # whatever the create-time metric (the reference's default is
        # inner product, which would invert the ranking).
        super().__init__(d, resolve_metric("L2"), metric_arg)
        self.nbits = int(d) if nbits is None else int(nbits)
        if self.nbits <= 0:
            raise errors.InvalidInputError(
                f"LSH bit count must be positive, got {self.nbits}")
        self.rotate = bool(rotate)
        self.train_thresholds = bool(train_thresholds)
        self._thresholds: np.ndarray | None = None
        if self.rotate or self.nbits != d:
            from ..transforms import RandomRotationMatrix

            self._rot = RandomRotationMatrix(d, self.nbits,
                                             seed=ROTATION_SEED).A
        else:
            self._rot = None
        self._codes = self._code_store()

    def shard_over(self, mesh) -> None:
        """faiss_to_gpu analogue: the ±1 code corpus (an inner-product Flat
        index) row-placed like any Flat placement."""
        self._codes.set_placement(row_placement(mesh))
        self._codes.device_vectors()

    def _code_store(self) -> FlatIndex:
        return FlatIndex(self.nbits, resolve_metric("INNER_PRODUCT"),
                         storage="pm1_i8")

    # --- lifecycle -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self._codes.ntotal

    @property
    def is_trained(self) -> bool:
        return not self.train_thresholds or self._thresholds is not None

    @property
    def requires_training(self) -> bool:
        return self.train_thresholds

    def train(self, x) -> None:
        if self.is_trained:
            return
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            raise errors.TrainingTooSmallError(0, 1)
        self._thresholds = self._project(x).mean(axis=0)

    def _project(self, x: np.ndarray) -> np.ndarray:
        if self._rot is not None:
            return x @ self._rot
        return x[:, :self.nbits]

    def encode(self, x: np.ndarray) -> np.ndarray:
        """(n, d) float32 → (n, nbits) ±1 float32 sign codes."""
        p = self._project(x)
        if self._thresholds is not None:
            p = p - self._thresholds
        return np.where(p > 0, np.float32(1), np.float32(-1))

    def add(self, x) -> None:
        if not self.is_trained:
            raise _not_trained()
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
        self._codes.add(self.encode(x))

    # --- search ----------------------------------------------------------
    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """The code store's dispatch on the encoded (checked) queries, its
        dots mapped to Hamming distances on the device; the inner padding
        sentinel (-inf) maps to +inf, the L2 / Hamming missing-slot
        sentinel."""
        if not self.is_trained:
            raise _not_trained()
        disp = self._codes.search_dispatch(self.encode(xq), k, params,
                                           selector)
        if disp is None:
            return None
        return disp._replace(dist=(float(self.nbits) - disp.dist) * 0.5)

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        state = {
            "code_bits": np.packbits(self._codes.vectors() > 0, axis=1),
            "ntotal": np.int64(self.ntotal),
        }
        if self._rot is not None:
            state["rot"] = self._rot
        if self._thresholds is not None:
            state["thresholds"] = self._thresholds
        return state

    def load_state(self, state: dict) -> None:
        n = int(state["ntotal"])
        bits = np.unpackbits(np.asarray(state["code_bits"], np.uint8),
                             axis=1)[:, :self.nbits]
        if state.get("rot") is not None:
            self._rot = np.array(state["rot"], np.float32)
        if state.get("thresholds") is not None:
            self._thresholds = np.array(state["thresholds"], np.float32)
        self._codes = self._code_store()
        if n:
            self._codes.add(np.where(bits[:n].astype(bool), np.float32(1),
                                     np.float32(-1)))
