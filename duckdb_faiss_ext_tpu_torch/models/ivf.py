"""IVF index with Flat, SQ8 / SQ4 / SQ6 / SQfp16 / SQbf16, PQ or RQ
storage: k-means-trained inverted lists.

The counterpart of ``duckdb_faiss_ext_tpu/models/ivf.py`` for the ``Flat``
encoding (faiss::IndexIVFFlat), the quantized scalar encodings
(faiss::IndexIVFScalarQuantizer, by_residual = false as index_factory
builds it) and the residual byte codecs (faiss::IndexIVFPQ and
IndexIVFResidualQuantizer, by_residual) as the reference exercises them:
``IVFn[,Flat]``, ``IVFn,SQ{8,4,6,fp16,bf16}``, ``IVFn,PQm[xb]`` and
``IVFn,RQMxb``
factory strings, deferred training through faiss_add, nprobe +
``quantiser.``-scoped search params (src/faiss_extension.cpp:675-689), and
native add_with_ids (ids stored beside the lists).  Flat and SQ storage
also ingest rows already on the card (``train_device`` / ``add_device``,
models/ivf_device.py), building the padded layout there.

State (the checkpoint both packages share): vectors (Flat) or codes (SQ,
with the trained per-dimension ranges ``sq_vmin`` / ``sq_scale``, none for
the float codecs, whose codes are the bytes of their half-width rows; PQ /
RQ,
with the trained ``pq_codebooks`` and the create parameters ``aniso_eta`` /
``rq_beam``), ids and list assignments in insertion order on the host, plus
the centroid table.  The SQ ranges are trained on the same subsample as the
coarse k-means; being min / max, they are bit-equal to the JAX package's
from the same rows, whatever the centroids.  PQ / RQ codebooks are trained
on the residuals x − centroid[assign(x)] of that subsample.  Rows are
assigned and encoded on the index's device, in chunks; only their codes are
kept.  The device layouts are rebuilt lazily after each mutation
(models/ivf_layout.py) and searched by models/ivf_serve.py.

The coarse quantizer (``quantizer``: Flat, HNSW, PQ or a nested IVF, as the
description names it) mirrors FAISS's graph shape: it holds the centroids
(trained on them first where it needs training), takes ``ivf.``-scoped
create params, and ``quantiser.``-scoped search params parse; assignment
and probing never search through it (one fused fp32 distance tile each),
as in the JAX package.

The create parameter ``assign_topk`` (capped assignment of
device-resident ingest) is accepted and stored as in the JAX package; as
there, device-resident ingest refuses the float codecs, which have no
padded layout and search through the sorted+gather decode scan.

SOAR (create parameter ``soar_lambda`` > 0, Sun et al. 2023): every row
also joins a second list chosen so that its residual there is
near-orthogonal to the primary one (``_assign_soar``, fp32 on the index's
device).  The copies are stored as duplicated rows, so every layout and
scan works unchanged; ``ntotal`` counts logical rows and ``_nstored``
storage rows, ``_srcrow`` maps each storage row to its logical row and
``_logical_rows`` each logical row to its first storage row.  A search
fetches 2k candidates and drops same-source duplicates on the host
(models/ivf_serve.py); the state keys ``soar_lambda``, ``soar_srcrow`` and
``soar_rows`` carry it.  The IMI coarse quantizer is the subclass in
models/imi.py.  ``shard_over`` (faiss_to_device) places the lists over a
device mesh (models/ivf_sharded.py).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .. import errors
from ..metrics import Metric
from ..ops.distance import pairwise_tile
from ..ops.flat_search import SIMILARITY_METRICS, exact_topk
from ..ops.kmeans import (DEFAULT_NITER, DEFAULT_SEED, kmeans_fit,
                          subsample_for_training)
from ..ops.pq import (codec_decode, codec_encode, codec_train,
                      pq_encode_anisotropic, pq_train_anisotropic)
from ..ops.sq import (FLOAT_CODECS, SQ_LEVELS, float_encode,
                      sq_code_width, sq_decode, sq_pack, sq_quantize,
                      sq_ranges, sq_train)
from ..utils.config import full_fp32, resolve_device
from .base import Index, as_matrix
from .ivf_device import IVFDevice
from .ivf_layout import IVFLayout
from .ivf_serve import IVFServe
from .ivf_sharded import IVFSharded

#: scalar-quantizer encodings built here
SQ_ENCODINGS = ("SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16")

#: rows a chunk of the device-side assignment and encoding takes
_INGEST_CHUNK = 1 << 18

_PQ_RE = re.compile(r"^PQ(\d+)(?:x(\d+))?$")
_RQ_RE = re.compile(r"^RQ(\d+)x(\d+)$")


class IVFIndex(IVFLayout, IVFServe, IVFDevice, IVFSharded, Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float,
                 nlist: int, quantizer: Index, encoding: str = "Flat"):
        super().__init__(d, metric, metric_arg)
        #: PQ / RQ storage: code bytes (subquantizers or stages) per row and
        #: bits per code, None otherwise; the codec "pq" or "rq"
        self.pq_m = self.pq_nbits = None
        self.pq_codec = "pq"
        #: "sq8" | "sq4" | "sq6" | "fp16" | "bf16", or None
        self.sq_type = None
        mpq, mrq = _PQ_RE.match(encoding), _RQ_RE.match(encoding)
        if mpq:
            self.pq_m = int(mpq.group(1))
            self.pq_nbits = int(mpq.group(2)) if mpq.group(2) else 8
            if d % self.pq_m != 0:
                raise errors.InvalidInputError(
                    f"The dimension of the vector ({d}) must be a "
                    f"multiple of the number of subquantizers "
                    f"({self.pq_m})")
        elif mrq:
            self.pq_m, self.pq_nbits = int(mrq.group(1)), int(mrq.group(2))
            self.pq_codec = "rq"
            if not 1 <= self.pq_nbits <= 8:
                raise errors.InvalidInputError(
                    f"RQ supports 1-8 bits per stage (uint8 code "
                    f"storage), got {self.pq_nbits}")
        elif encoding in SQ_ENCODINGS:
            self.sq_type = (encoding[2:] if encoding[2:] in FLOAT_CODECS
                            else encoding.lower())
        elif encoding != "Flat":
            raise errors.InvalidInputError(
                f"IVF encoding {encoding} is not supported (use Flat, PQm, "
                f"RQMxb, SQ8, SQ4, SQ6, SQfp16 or SQbf16)")
        if encoding != "Flat" and metric.name not in ("L2", "INNER_PRODUCT"):
            raise errors.InvalidInputError(
                f"{encoding} indexes support only L2 and INNER_PRODUCT "
                f"metrics, got {metric.name}")
        #: create parameters of the PQ / RQ storage (anisotropic_eta, beam)
        self.aniso_eta = 1.0
        self.rq_beam: int | None = None
        #: where the lists live and searches run
        self.device = resolve_device()
        self.nlist = int(nlist)
        self.quantizer = quantizer
        self.encoding = encoding
        self.nprobe_default = 1  # faiss::IndexIVF::nprobe default
        self.train_seed = DEFAULT_SEED
        self.train_niter = DEFAULT_NITER
        self.train_balance = 0.0
        #: capped device-ingest assignment: top-T candidate lists (0 = off)
        self.assign_topk = 0
        #: SOAR dual assignment weight (0 = off) and its bookkeeping: storage
        #: row → logical row, logical row → first storage row (None when off)
        self.soar_lambda = 0.0
        self._srcrow: np.ndarray | None = None
        self._logical_rows: np.ndarray | None = None
        #: device-resident state (models/ivf_device.py), or None
        self._dr = None
        #: the mesh the lists are placed over by faiss_to_device
        #: (models/ivf_sharded.py), or None
        self._shard_mesh = None
        self._centroids: np.ndarray | None = None
        self._sq_vmin: np.ndarray | None = None
        self._sq_scale: np.ndarray | None = None
        self._pq_codebooks: np.ndarray | None = None
        if self.pq_m is not None:
            self._codes = np.empty((0, self.pq_m), np.uint8)
        elif self.sq_type is not None:
            self._codes = np.empty((0, sq_code_width(d, self.sq_type)),
                                   np.uint8)
        else:
            self._codes = None
        self._xb = np.empty((0, d), dtype=np.float32)
        self._ids = np.empty((0,), dtype=np.int64)
        self._assign = np.empty((0,), dtype=np.int32)
        self._version = 0
        self._invalidate()

    # --- lifecycle -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        """Logical rows (the user's view); with SOAR each is stored twice."""
        n = self._ids.shape[0]
        return n // 2 if self.soar_lambda > 0.0 else n

    @property
    def _nstored(self) -> int:
        """Storage rows (inverted-list entries), which layouts, masks and
        scans count."""
        return self._ids.shape[0]

    @property
    def centroids(self) -> np.ndarray | None:
        """The coarse centroid table (nlist, d) fp32, read-only; None until
        trained."""
        if self._centroids is None:
            return None
        view = self._centroids.view()
        view.flags.writeable = False
        return view

    @property
    def is_trained(self) -> bool:
        if self.sq_type in SQ_LEVELS and self._sq_vmin is None:
            return False
        if self.pq_m is not None and self._pq_codebooks is None:
            return False
        return self._centroids is not None

    @property
    def requires_training(self) -> bool:
        return True

    def train(self, x) -> None:
        if self.is_trained:
            return  # FAISS skips retraining a trained quantizer
        self._fit(as_matrix(x, self.d))

    def _on_device(self, x) -> torch.Tensor:
        """Host rows or a tensor, on the index's device."""
        return (x if torch.is_tensor(x) else torch.from_numpy(x)).to(
            self.device)

    def _fit(self, x) -> None:
        """Training on (n, d) fp32 rows, host numpy or a tensor on the
        index's device (``train_device``)."""
        self._centroids, x = self._train_coarse(x)
        self._populate_quantizer()
        if self.pq_m is not None:
            ksub = 1 << self.pq_nbits
            if x.shape[0] < ksub:
                self._centroids = None
                raise errors.TrainingTooSmallError(x.shape[0], ksub)
            self._pq_codebooks = self._train_codebooks(x)
        if self.sq_type in SQ_LEVELS:
            vmin, scale = sq_train(self._on_device(x),
                                   SQ_LEVELS[self.sq_type])
            self._sq_vmin = vmin.cpu().numpy()
            self._sq_scale = scale.cpu().numpy()
        self._invalidate()

    #: IMIIndex sets this False: its quantizer is never consulted, and
    #: copying the materialized cell table into it would double memory.
    _mirror_quantizer = True

    def _populate_quantizer(self) -> None:
        """Mirror the centroid table into the quantizer index (faiss graph
        shape; again after load_state rebuilds the quantizer empty).  A
        quantizer that needs training (a nested ``IVFn(IVFm,...)``, a
        ``PQm``) is trained on the table first, as faiss
        Level1Quantizer::train_q1 does."""
        if not self._mirror_quantizer or self.quantizer.ntotal != 0:
            return
        if not self.quantizer.is_trained:
            self.quantizer.train(self._centroids)
        self.quantizer.add(self._centroids)

    def _subsample_train(self, x, k: int):
        """Too-few-points check + FAISS's seeded per-centroid subsample
        (numpy's generator, as in the JAX package: the same rows); rows on
        the card are selected there."""
        n = x.shape[0]
        if n < k:
            raise errors.TrainingTooSmallError(n, k)
        nsub = subsample_for_training(n, k)
        if nsub < n:
            rng = np.random.default_rng(self.train_seed)
            sel = np.sort(rng.choice(n, size=nsub, replace=False))
            x = (x[torch.from_numpy(sel).to(x.device)] if torch.is_tensor(x)
                 else x[sel])
        return x

    def _train_coarse(self, x):
        """Fit the coarse quantizer on the index's device; returns the
        (nlist, d) centroid table and the training subsample (which the SQ
        ranges are trained on).  Spherical for inner product (faiss
        Level1Quantizer::train_q1)."""
        x = self._subsample_train(x, self.nlist)
        centroids, _ = kmeans_fit(
            self._on_device(x), self.nlist,
            niter=self.train_niter, seed=self.train_seed,
            balance=self.train_balance,
            spherical=self.metric.name == "INNER_PRODUCT")
        return centroids.cpu().numpy().astype(np.float32), x

    def _train_codebooks(self, x: np.ndarray) -> np.ndarray:
        """Residual PQ / RQ codebooks on the index's device, trained on
        x − centroid[assign(x)] of the coarse training subsample (anisotropic
        PQ with the ORIGINAL rows as the anisotropy axis)."""
        xt = torch.from_numpy(x).to(self.device)
        cents = torch.from_numpy(self._centroids).to(self.device)
        resid = xt - cents[torch.from_numpy(self._assign_lists(x)).to(
            self.device).long()]
        ksub = 1 << self.pq_nbits
        if self.aniso_eta > 1.0:
            cb = pq_train_anisotropic(resid, self.pq_m, ksub, self.aniso_eta,
                                      seed=self.train_seed, dirs=xt)
        else:
            cb = codec_train(resid, self.pq_m, ksub, self.pq_codec,
                             seed=self.train_seed)
        return cb.cpu().numpy().astype(np.float32)

    def _require_trained(self):
        if not self.is_trained:
            raise errors.InvalidInputError(
                "Index is not trained; call train (or faiss_manual_train) "
                "before adding or searching")

    # --- ingest ----------------------------------------------------------
    def add(self, x) -> None:
        x = as_matrix(x, self.d)
        start = self.ntotal
        self.add_with_ids(
            x, np.arange(start, start + x.shape[0], dtype=np.int64))

    def add_with_ids(self, x, ids) -> None:
        self._require_trained()
        if self._dr is not None:
            raise errors.InvalidInputError(
                "host-path adds cannot be mixed with device-resident "
                "ingest on the same index (use add_device)")
        x = as_matrix(x, self.d)
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.shape[0] != x.shape[0]:
            raise errors.add_error(
                f"number of ids ({ids.shape[0]}) does not match number of "
                f"vectors ({x.shape[0]})")
        if x.shape[0] == 0:
            return
        assign = self._assign_lists(x)
        if self.soar_lambda > 0.0:
            # Each row also joins its SOAR list, as a duplicated storage row.
            nb, start = x.shape[0], self._nstored
            logical = np.arange(self.ntotal, self.ntotal + nb, dtype=np.int64)
            if self._srcrow is None:
                self._srcrow = np.empty((0,), np.int64)
                self._logical_rows = np.empty((0,), np.int64)
            self._srcrow = np.concatenate([self._srcrow, logical, logical])
            self._logical_rows = np.concatenate(
                [self._logical_rows,
                 np.arange(start, start + nb, dtype=np.int64)])
            assign = np.concatenate([assign, self._assign_soar(x, assign)])
            x = np.concatenate([x, x])
            ids = np.concatenate([ids, ids])
        if self.pq_m is not None:
            self._codes = np.concatenate([self._codes,
                                          self._pq_encode(x, assign)])
        elif self.sq_type is not None:
            self._codes = np.concatenate([self._codes, self._sq_encode(x)])
        else:
            self._xb = np.concatenate([self._xb, x], axis=0)
        self._ids = np.concatenate([self._ids, ids])
        self._assign = np.concatenate([self._assign, assign])
        self._invalidate()

    def reconstruct(self, key: int) -> np.ndarray:
        """Stored vector by position (decoded for SQ / PQ / RQ storage; PQ /
        RQ add the list's centroid back)."""
        key = int(key)
        if key < 0 or key >= self.ntotal:
            raise errors.InvalidInputError(
                f"Position {key} is out of range (ntotal={self.ntotal})")
        if self._dr is not None:
            return self._device_reconstruct(key)
        if self._logical_rows is not None:
            # SOAR: a logical row indirects to its first storage row.
            key = int(self._logical_rows[key])
        if self.pq_m is not None:
            resid = codec_decode(torch.from_numpy(self._codes[key:key + 1]),
                                 torch.from_numpy(self._pq_codebooks),
                                 self.pq_codec)[0].numpy()
            return resid + self._centroids[self._assign[key]]
        if self.sq_type is not None:
            return sq_decode(torch.from_numpy(self._codes[key:key + 1]),
                             *self._sq_ranges("cpu"), self.sq_type)[0].numpy()
        return self._xb[key]

    def _pq_encode(self, x: np.ndarray, assign: np.ndarray) -> np.ndarray:
        """Residual PQ / RQ codes of rows x in their lists ``assign``,
        encoded on the index's device in chunks."""
        cents = torch.from_numpy(self._centroids).to(self.device)
        cb = torch.from_numpy(self._pq_codebooks).to(self.device)
        out = []
        for i in range(0, x.shape[0], _INGEST_CHUNK):
            xc = torch.from_numpy(x[i:i + _INGEST_CHUNK]).to(self.device)
            resid = xc - cents[torch.from_numpy(
                assign[i:i + _INGEST_CHUNK]).to(self.device).long()]
            if self.aniso_eta > 1.0:
                codes = pq_encode_anisotropic(resid, cb, self.aniso_eta,
                                              dirs=xc)
            else:
                codes = codec_encode(resid, cb, self.pq_codec,
                                     beam=self.rq_beam)
            out.append(codes.cpu().numpy())
        return np.concatenate(out)

    def _sq_encode(self, x: np.ndarray) -> np.ndarray:
        """Quantize rows on the index's device (in chunks), pack them on
        the host; the float codecs' rows cast on the host."""
        if self.sq_type in FLOAT_CODECS:
            return float_encode(torch.from_numpy(x), self.sq_type).numpy()
        vmin, scale = self._sq_ranges()
        levels = SQ_LEVELS[self.sq_type]
        q = np.concatenate([
            sq_quantize(torch.from_numpy(x[i:i + _INGEST_CHUNK]).to(
                self.device), vmin, scale, levels).cpu().numpy()
            for i in range(0, x.shape[0], _INGEST_CHUNK)])
        return sq_pack(q, self.sq_type)

    def _sq_ranges(self, device=None):
        """(vmin, scale) (d,) fp32 on ``device`` (the index's by default)."""
        return sq_ranges(self._sq_vmin, self._sq_scale, self.d,
                         self.device if device is None else device)

    def _assign_lists(self, x) -> np.ndarray:
        """Best list of each new vector (host rows or a tensor on the
        index's device) by the index metric, in fp32 chunks on the index's
        device (first list on ties), fetched once."""
        sim = self.metric.name in SIMILARITY_METRICS
        return self._assign_tiles(
            x, 1, lambda tile: (tile.argmax(1) if sim
                                else tile.argmin(1))[:, None])[:, 0]

    def _assign_soar(self, x: np.ndarray, assign: np.ndarray) -> np.ndarray:
        """SOAR's second list of each row: the argmin over lists l ≠ primary
        of ‖x − c_l‖² + λ·((x − c_l)·r̂)², r̂ the unit primary residual
        (L2 geometry, SOAR's derivation), in fp32 chunks on the index's
        device; first list on ties."""
        lam = float(self.soar_lambda)
        cents = torch.from_numpy(self._centroids).to(self.device)
        cn = (cents * cents).sum(1)[None, :]
        chunk = max(1024, min(65536, (1 << 27) // max(self.nlist, 1)))
        out = []
        with full_fp32():
            for i in range(0, x.shape[0], chunk):
                xc = torch.from_numpy(x[i:i + chunk]).to(self.device)
                a1 = torch.from_numpy(assign[i:i + chunk]).to(
                    self.device).long()
                r1 = xc - cents[a1]
                r1h = r1 / (r1 * r1).sum(1, keepdim=True).clamp(
                    min=1e-20).sqrt()
                sqdist = (xc * xc).sum(1, keepdim=True) - 2.0 * (
                    xc @ cents.T) + cn
                proj = (xc * r1h).sum(1, keepdim=True) - r1h @ cents.T
                cost = sqdist + lam * proj * proj
                cost[torch.arange(a1.shape[0], device=self.device), a1] = \
                    float("inf")
                out.append(cost.argmin(1).to(torch.int32).cpu().numpy())
        return np.concatenate(out) if out else np.empty((0,), np.int32)

    def _assign_candidates(self, x, t: int) -> np.ndarray:
        """(n, t) int32 nearest lists of each vector, nearest first (lower
        list on ties), from the same distance tiles."""
        sim = self.metric.name in SIMILARITY_METRICS
        return self._assign_tiles(
            x, t, lambda tile: exact_topk(tile if sim else -tile, t)[1])

    def _assign_tiles(self, x, width: int, pick) -> np.ndarray:
        """``pick`` of each fp32 (chunk × nlist) distance tile of x against
        the centroids, as (n, width) int32, fetched once."""
        cents = torch.from_numpy(self._centroids).to(self.device)
        # Bound the transient (chunk × nlist) score tile to ~512 MB, and an
        # elementwise metric's (chunk × nlist × d) broadcast to 2^24.
        if self.metric.uses_mxu:
            chunk = max(1024, min(65536, (1 << 27) // max(self.nlist, 1)))
        else:
            chunk = max(1, (1 << 24) // max(self.nlist * self.d, 1))
        out = torch.empty((x.shape[0], width), dtype=torch.int32,
                          device=self.device)
        with full_fp32():
            for i in range(0, x.shape[0], chunk):
                tile = pairwise_tile(self._on_device(x[i:i + chunk]), cents,
                                     self.metric.name, self.metric_arg)
                out[i:i + chunk] = pick(tile).to(torch.int32)
        return out.cpu().numpy()

    # --- create params ----------------------------------------------------
    def apply_create_params(self, params) -> None:
        # Training knobs beyond the reference's surface: seed/niter for
        # reproducibility, kmeans_balance for skew-aware list sizing.
        self.train_seed = params.get_int("train_seed", self.train_seed)
        self.train_niter = params.get_int("train_niter", self.train_niter)
        self.train_balance = params.get_float("kmeans_balance", 0.0)
        # Capped assignment of device-resident ingest: each row goes to the
        # nearest of its top-T lists with free capacity (0 / 1 = nearest).
        self.assign_topk = params.get_int("assign_topk", 0)
        beam = params.get_int("beam")
        if beam is not None:
            # RQ-storage encode beam (models/rq.DEFAULT_BEAM otherwise).
            if self.pq_codec != "rq":
                raise errors.InvalidInputError(
                    "beam applies to RQ storage (IVFn,RQMxb)")
            self.rq_beam = max(1, beam)
        lam = params.get_float("soar_lambda")
        if lam is not None:
            # SOAR dual assignment (see add_with_ids); lambda weights the
            # orthogonality term, ~1.0 is the paper's sweet spot.
            if lam < 0.0:
                raise errors.InvalidInputError(
                    f"soar_lambda must be >= 0, got {lam}")
            if self.nlist < 2 and lam > 0.0:
                raise errors.InvalidInputError(
                    "SOAR needs at least 2 inverted lists")
            self.soar_lambda = lam
        eta = params.get_float("anisotropic_eta")
        if eta is not None:
            # Score-aware residual quantization (PQ storage only); the
            # anisotropy axis is the ORIGINAL datapoint direction.
            if eta < 1.0:
                raise errors.InvalidInputError(
                    f"anisotropic_eta must be >= 1.0, got {eta}")
            if self.pq_m is None or self.pq_codec != "pq":
                raise errors.InvalidInputError(
                    "anisotropic_eta applies to PQ storage (IVFn,PQm)")
            self.aniso_eta = eta
        self.quantizer.apply_create_params(params.scoped("ivf."))

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        if self._dr is not None:
            # The resident rows gathered back in insertion order: the
            # checkpoint loads as an ordinary host-path index.
            rows = self._device_materialize()
            state = {"xb": rows if self.sq_type is None else self._xb,
                     "ids": self._ids, "assign": self._assign,
                     "centroids": self._centroids}
            if self.sq_type is not None:
                state.update(codes=rows, sq_vmin=self._sq_vmin,
                             sq_scale=self._sq_scale)
            return state
        state = {"xb": self._xb, "ids": self._ids, "assign": self._assign}
        if self.soar_lambda > 0.0:
            # Search must keep fetching 2k and dropping duplicates.
            state["soar_lambda"] = np.float32(self.soar_lambda)
            if self._srcrow is not None:
                state["soar_srcrow"] = self._srcrow
                state["soar_rows"] = self._logical_rows
        if self.aniso_eta > 1.0:
            state["aniso_eta"] = np.float32(self.aniso_eta)
        if self.rq_beam is not None:
            state["rq_beam"] = np.int64(self.rq_beam)
        if self._centroids is not None:
            state["centroids"] = self._centroids
        if self.pq_m is not None:
            state["codes"] = self._codes
            if self._pq_codebooks is not None:
                state["pq_codebooks"] = self._pq_codebooks
        if self.sq_type is not None:
            state["codes"] = self._codes
            if self._sq_vmin is not None:
                state["sq_vmin"] = self._sq_vmin
                state["sq_scale"] = self._sq_scale
        return state

    def load_state(self, state: dict) -> None:
        known = {"xb", "ids", "assign", "centroids", "soar_lambda",
                 "soar_srcrow", "soar_rows"}
        if self.sq_type is not None:
            known |= {"codes", "sq_vmin", "sq_scale"}
        if self.pq_m is not None:
            known |= {"codes", "pq_codebooks", "aniso_eta", "rq_beam"}
        unported = sorted(set(state) - known)
        if unported:
            raise errors.not_available(f"IVF state {unported[0]}")
        if state.get("soar_lambda") is not None:
            self.soar_lambda = float(state["soar_lambda"])
        if state.get("soar_srcrow") is not None:
            self._srcrow = np.asarray(state["soar_srcrow"],
                                      np.int64).reshape(-1)
            self._logical_rows = np.asarray(state["soar_rows"],
                                            np.int64).reshape(-1)
        self._xb = np.asarray(state["xb"], np.float32).reshape(-1, self.d)
        self._ids = np.asarray(state["ids"], np.int64).reshape(-1)
        self._assign = np.asarray(state["assign"], np.int32).reshape(-1)
        if self.pq_m is not None:
            if state.get("aniso_eta") is not None:
                self.aniso_eta = float(state["aniso_eta"])
            if state.get("rq_beam") is not None:
                self.rq_beam = int(state["rq_beam"])
            # Copies: arrays carried from the JAX package are read-only.
            self._codes = np.array(state["codes"], np.uint8).reshape(
                -1, self.pq_m)
            cb = state.get("pq_codebooks")
            self._pq_codebooks = (np.array(cb, np.float32)
                                  if cb is not None else None)
        if self.sq_type is not None:
            self._codes = np.asarray(state["codes"], np.uint8).reshape(
                -1, sq_code_width(self.d, self.sq_type))
            vmin = state.get("sq_vmin")
            # Copies: arrays carried from the JAX package are read-only.
            self._sq_vmin = (np.array(vmin, np.float32).reshape(-1)
                             if vmin is not None else None)
            self._sq_scale = (np.array(state["sq_scale"], np.float32)
                              .reshape(-1) if vmin is not None else None)
        cents = state.get("centroids")
        # A copy: arrays carried from the JAX package are read-only, and
        # torch.from_numpy wants writable memory.
        self._centroids = (np.array(cents, np.float32).reshape(-1, self.d)
                           if cents is not None else None)
        if self._centroids is not None:
            self._populate_quantizer()
        self._invalidate()
