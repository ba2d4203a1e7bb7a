"""Vector transforms: L2norm / PCA / RR / ITQ / OPQ / Pad
(faiss::VectorTransform family).

The counterpart of ``duckdb_faiss_ext_tpu/transforms.py``, reachable in the
reference through factory prefixes (``PCA64,...``, ``OPQ16,...``,
``L2norm,...``: faiss::index_factory grammar, src/faiss_extension.cpp:154-155).
Each transform maps (n, d_in) → (n, d_out) before the wrapped index sees the
data (models/pretransform.py).

``apply`` and ``reverse`` take and return host numpy rows and compute on
``config.device`` (the card unless the CPU was asked for), in chunks.
Training (eigendecomposition for PCA, the alternating procrustes loops of
ITQ and OPQ) runs there too.  Training and ``apply`` always run in full
fp32 (``utils.config.full_fp32``) whatever the precision mode, as the JAX
package's ``Precision.HIGHEST`` did: a TF32 transform would move the
inner index's inputs by about 1e-3 relative, and Flat would no longer be
exact.  ``PadTransform`` only copies rows and stays on the host.

Deliberate deviations from the JAX package (the trained state differs, the
behaviour does not): eigenvector signs from ``torch.linalg.eigh`` are not
those of ``jnp.linalg.eigh``, so PCA spans the same subspace with the same
eigenvalues but may flip columns; OPQ's inner PQ draws its k-means samples
from a ``torch.Generator`` (ops/kmeans.py), as IVF's k-means does.
``RandomRotationMatrix`` and the initial rotations of PCAR / ITQ / OPQ draw
from ``numpy.random.default_rng(seed)`` exactly as the JAX package does, so
RR's matrix is byte-equal to the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import errors
from .ops.kmeans import DEFAULT_SEED
from .utils.config import full_fp32, resolve_device

#: rows a chunk of ``apply`` / ``reverse`` takes on the device
APPLY_CHUNK = 1 << 18


def _seeded_rotation(seed: int, n: int, dtype=np.float32) -> np.ndarray:
    """The JAX package's seeded orthogonal (n, n): Q of a QR of a
    ``default_rng(seed)`` Gaussian."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)).astype(dtype))
    return q


class VectorTransform:
    """Linear-ish map y = f(x); trained transforms hold host arrays."""

    def __init__(self, d_in: int, d_out: int):
        self.d_in = int(d_in)
        self.d_out = int(d_out)
        self.device = resolve_device()

    @property
    def is_trained(self) -> bool:
        return True

    def train(self, x: np.ndarray) -> None:  # noqa: B027
        pass

    def apply(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reverse(self, y: np.ndarray) -> np.ndarray:
        raise errors.InvalidInputError(
            f"{type(self).__name__} has no reverse transform")

    def _rows(self, x: np.ndarray, fn) -> np.ndarray:
        """fn over device chunks of host rows x, in full fp32; host result."""
        x = np.asarray(x, np.float32)
        out = []
        with full_fp32():
            for i in range(0, max(x.shape[0], 1), APPLY_CHUNK):
                xc = torch.from_numpy(x[i:i + APPLY_CHUNK]).to(self.device)
                out.append(fn(xc).cpu().numpy())
        return np.ascontiguousarray(np.concatenate(out), dtype=np.float32)

    # serialization
    def state_dict(self) -> dict:
        return {}

    def load_state(self, state: dict) -> None:  # noqa: B027
        pass


class L2NormTransform(VectorTransform):
    """faiss::NormalizationTransform(norm=2): row-normalize."""

    def __init__(self, d: int):
        super().__init__(d, d)

    def apply(self, x: np.ndarray) -> np.ndarray:
        return self._rows(x, lambda t: t / t.norm(dim=1, keepdim=True)
                          .clamp(min=1e-20))


class LinearTransform(VectorTransform):
    """y = (x - mean) @ A with orthonormal-ish A (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out)
        self.A: np.ndarray | None = None       # (d_in, d_out)
        self.mean: np.ndarray | None = None    # (d_in,)
        self._dev = None                       # (A, mean) on the device
        self._Ainv = None                      # lazy pseudo-inverse

    @property
    def is_trained(self) -> bool:
        return self.A is not None

    def _set(self, A, mean) -> None:
        self.A = np.ascontiguousarray(A, dtype=np.float32)
        self.mean = np.ascontiguousarray(mean, dtype=np.float32)
        self._dev = self._Ainv = None

    def _device_state(self):
        if self._dev is None:
            self._dev = (torch.from_numpy(self.A).to(self.device),
                         torch.from_numpy(self.mean).to(self.device))
        return self._dev

    def apply(self, x: np.ndarray) -> np.ndarray:
        if self.A is None:
            raise errors.InvalidInputError(
                f"{type(self).__name__} is not trained")
        A, mean = self._device_state()
        return self._rows(x, lambda t: (t - mean[None, :]) @ A)

    def reverse(self, y: np.ndarray) -> np.ndarray:
        # Pseudo-inverse, not transpose: whitened PCA columns are scaled by
        # 1/sqrt(eigenvalue) and are no longer orthonormal.
        A, mean = self._device_state()
        if self._Ainv is None:
            with full_fp32():
                self._Ainv = torch.linalg.pinv(A)
        return self._rows(y, lambda t: t @ self._Ainv + mean[None, :])

    def state_dict(self) -> dict:
        state = {}
        if self.A is not None:
            state["A"] = self.A
            state["mean"] = self.mean
        return state

    def load_state(self, state: dict) -> None:
        if "A" in state:
            self._set(np.array(state["A"], np.float32),
                      np.array(state["mean"], np.float32))


def _centered(t: VectorTransform, x: np.ndarray, what: str):
    """(rows on the device, their mean, rows − mean), checking that there
    are at least d_out training points."""
    x = np.asarray(x, np.float32)
    if x.shape[0] < t.d_out:
        raise errors.InvalidInputError(
            f"{what} training needs at least d_out={t.d_out} points, "
            f"got {x.shape[0]}")
    xd = torch.from_numpy(x).to(t.device)
    mean = xd.mean(0)
    return xd, mean, xd - mean[None, :]


class PCAMatrix(LinearTransform):
    """faiss::PCAMatrix: top-d_out principal components; ``random_rotation``
    (PCAR) composes a random orthogonal rotation after projection; ``whiten``
    (PCAW) scales components by 1/sqrt(eigenvalue)."""

    def __init__(self, d_in: int, d_out: int, *, random_rotation=False,
                 whiten=False, seed: int = DEFAULT_SEED):
        if d_out > d_in:
            raise errors.InvalidInputError(
                f"PCA output dimension {d_out} exceeds input {d_in}")
        super().__init__(d_in, d_out)
        self.random_rotation = bool(random_rotation)
        self.whiten = bool(whiten)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        if self.is_trained:
            return
        with full_fp32():
            _, mean, xc = _centered(self, x, "PCA")
            cov = (xc.T @ xc) / xc.shape[0]
            eigval, eigvec = torch.linalg.eigh(cov)       # ascending
            order = torch.argsort(-eigval)[: self.d_out]
            A = eigvec[:, order]
            if self.whiten:
                A = A / eigval[order].clamp(min=1e-10).sqrt()[None, :]
            if self.random_rotation:
                A = A @ torch.from_numpy(
                    _seeded_rotation(self.seed, self.d_out)).to(self.device)
        self._set(A.cpu().numpy(), mean.cpu().numpy())


class PadTransform(VectorTransform):
    """faiss::RemapDimensionsTransform as the factory exposes it (``Pad{n}``
    prefix): pad vectors with zero dimensions up to d_out.  Distances are
    preserved exactly; reverse truncates the padding (host copies)."""

    def __init__(self, d_in: int, d_out: int):
        if d_out < d_in:
            raise errors.InvalidInputError(
                f"Pad output dimension {d_out} is below input {d_in}")
        super().__init__(d_in, d_out)

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        out = np.zeros((x.shape[0], self.d_out), np.float32)
        out[:, : self.d_in] = x
        return out

    def reverse(self, y: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(y, np.float32)
                                    [:, : self.d_in])


class RandomRotationMatrix(LinearTransform):
    """faiss::RandomRotationMatrix (``RR[n]`` factory prefix): a fixed
    seeded random orthogonal map.  d_out <= d_in takes the leading columns
    of a (d_in, d_in) rotation; d_out > d_in embeds into the leading rows
    of a (d_out, d_out) rotation (norms preserved either way)."""

    def __init__(self, d_in: int, d_out: int | None = None, *,
                 seed: int = DEFAULT_SEED):
        d_out = d_in if d_out is None else int(d_out)
        super().__init__(d_in, d_out)
        self.seed = int(seed)
        q = _seeded_rotation(self.seed, max(self.d_in, self.d_out),
                             np.float64)
        self._set(q[: self.d_in, : self.d_out],
                  np.zeros((self.d_in,), np.float32))


class ITQTransform(LinearTransform):
    """faiss::ITQTransform (``ITQ[n]`` factory prefix): centering, optional
    PCA to d_out, then the ITQ rotation (Gong & Lazebnik) that minimizes
    binarization error: alternate B = sign(V R) with the procrustes update
    R ← U Wᵀ from svd(Vᵀ B).  Output is the rotated real-valued projection;
    a downstream LSH index binarizes it (``ITQ64,LSH``)."""

    def __init__(self, d_in: int, d_out: int | None = None,
                 do_pca: bool | None = None, *, niter: int = 50,
                 seed: int = DEFAULT_SEED):
        d_out = d_in if d_out is None else int(d_out)
        if d_out > d_in:
            raise errors.InvalidInputError(
                f"ITQ output dimension {d_out} exceeds input {d_in}")
        super().__init__(d_in, d_out)
        # index_factory passes do_pca = (d_out != d) for ITQTransform.
        self.do_pca = (d_out != d_in) if do_pca is None else bool(do_pca)
        self.niter = int(niter)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        if self.is_trained:
            return
        with full_fp32():
            _, mean, xc = _centered(self, x, "ITQ")
            if self.do_pca:
                pca = PCAMatrix(self.d_in, self.d_out, seed=self.seed)
                pca.train(x)
                A0 = torch.from_numpy(pca.A).to(self.device)
                v = xc @ A0
            else:
                A0 = torch.eye(self.d_in, self.d_out, device=self.device)
                v = xc
            R = torch.from_numpy(_seeded_rotation(self.seed, self.d_out)).to(
                self.device)
            for _ in range(self.niter):
                b = torch.sign(v @ R)
                u, _, wt = torch.linalg.svd(v.T @ b, full_matrices=False)
                R = u @ wt
            A = A0 @ R
        self._set(A.cpu().numpy(), mean.cpu().numpy())


class OPQMatrix(LinearTransform):
    """faiss::OPQMatrix: rotation minimizing PQ reconstruction error
    (OPQ-NP: alternate a PQ fit on the rotated data with the procrustes
    rotation update R ← U Vᵀ from svd(Xᵀ X̂))."""

    def __init__(self, d_in: int, m: int, d_out: int | None = None, *,
                 niter: int = 10, niter_pq: int = 4,
                 seed: int = DEFAULT_SEED):
        d_out = d_in if d_out is None else int(d_out)
        if d_out > d_in:
            raise errors.InvalidInputError(
                f"OPQ output dimension {d_out} exceeds input {d_in}")
        if d_out % m:
            raise errors.InvalidInputError(
                f"OPQ output dimension {d_out} must be a multiple of the "
                f"number of subquantizers ({m})")
        super().__init__(d_in, d_out)
        self.m = int(m)
        self.niter = int(niter)
        self.niter_pq = int(niter_pq)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        if self.is_trained:
            return
        from .ops.pq import pq_decode, pq_encode, pq_train

        x = np.asarray(x, np.float32)
        n = x.shape[0]
        ksub = min(256, max(2, n // 4))
        # OPQ converges on ~100k points; larger sets are subsampled (the
        # same rows as the JAX package's).
        if n > 100_000:
            rng = np.random.default_rng(self.seed)
            x = x[np.sort(rng.choice(n, 100_000, replace=False))]
        with full_fp32():
            xd = torch.from_numpy(x).to(self.device)
            mean = xd.mean(0)
            xc = xd - mean[None, :]
            R = torch.from_numpy(np.ascontiguousarray(
                _seeded_rotation(self.seed, self.d_in)[:, : self.d_out])).to(
                self.device)
            for _ in range(self.niter):
                xr = xc @ R
                cb = pq_train(xr, self.m, ksub, niter=self.niter_pq,
                              seed=self.seed)
                xrec = pq_decode(pq_encode(xr, cb), cb)
                u, _, vt = torch.linalg.svd(xc.T @ xrec, full_matrices=False)
                R = u @ vt
        self._set(R.cpu().numpy(), mean.cpu().numpy())
