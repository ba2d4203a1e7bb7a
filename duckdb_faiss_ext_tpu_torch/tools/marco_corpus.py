"""The MS MARCO stand-in corpus: 8,841,823 x 1536 unit-norm rows.

The reference benchmarks its indexes over MS MARCO passage ada-002
embeddings, 8,841,823 x 1536 (go/cmd/create_index/main.go:11); the data
cannot be fetched here, so the tools and ``chip_smoke.py`` draw a seeded
stand-in of the same shape on the device, chunk by chunk.  Two mixtures:

* ``"skewed"`` (the default, chip_smoke.py's SQ and graph phases): 4,096
  unit-norm centres with log-normal weights (the training chunk's weights
  drift from the rest's, as a corpus's first slice does), isotropic noise
  of norm 0.8 around them: tight clusters of uneven size;
* ``"balanced"`` (the JAX package's tools/marco_device.py --unit-norm and
  tools/marco_graph.py draw): 8,192 centres N(0, I), equal weights, noise
  N(0, I), so centre and noise are of equal norm and the clusters overlap.
  The JAX package draws it with JAX's RNG, so the rows differ; the
  distribution is the same.

Each row is normalised.  Any chunk can be drawn again from its index, so
exact search over all rows needs no copy of the corpus off the device.
"""

from __future__ import annotations

import numpy as np
import torch

#: rows and width of the reference's MS MARCO deployment
MARCO_N, MARCO_D = 8_841_823, 1536
#: skewed mixture: centres; log-weight spread, training-chunk drift; noise
#: norm
CENTERS, SIGMA, DRIFT, NOISE = 4096, 0.7, 0.5, 0.8
#: balanced mixture: centres
BALANCED_CENTERS = 8192
MIXTURES = ("skewed", "balanced")
#: rows a chunk
CHUNK = 262_144


class MarcoCorpus:
    """The corpus on ``device``, made chunk by chunk from seeded
    generators."""

    def __init__(self, seed: int = 11, device="cuda", d: int = MARCO_D,
                 centers: int | None = None, chunk_rows: int = CHUNK,
                 mixture: str = "skewed"):
        if mixture not in MIXTURES:
            raise ValueError(f"mixture must be one of {MIXTURES}")
        self.seed, self.device, self.d = seed, device, d
        self.chunk_rows, self.mixture = chunk_rows, mixture
        g = torch.Generator(device=device).manual_seed(seed)
        if mixture == "balanced":
            centers = centers or BALANCED_CENTERS
            self.centers = torch.randn(centers, d, device=device, generator=g)
            self.w_train = self.w_rest = torch.full((centers,), 1.0 / centers,
                                                    device=device)
            self.noise = 1.0
            return
        centers = centers or CENTERS
        self.centers = torch.nn.functional.normalize(
            torch.randn(centers, d, device=device, generator=g), dim=1)
        logw = torch.randn(centers, device=device, generator=g) * SIGMA
        drift = torch.randn(centers, device=device, generator=g) * DRIFT
        self.w_train = torch.softmax(logw, 0)
        self.w_rest = torch.softmax(logw + drift, 0)
        self.noise = NOISE / d ** 0.5

    def _draw(self, n, weights, stream):
        g = torch.Generator(device=self.device).manual_seed(
            self.seed * 1000 + stream)
        c = torch.multinomial(weights, n, replacement=True, generator=g)
        x = self.centers[c] + torch.randn(
            n, self.d, device=self.device, generator=g) * self.noise
        return torch.nn.functional.normalize(x, dim=1)

    def chunk(self, i: int, n: int | None = None) -> torch.Tensor:
        """Rows [i·chunk_rows, i·chunk_rows + n) on the device."""
        n = self.chunk_rows if n is None else n
        return self._draw(n, self.w_train if i == 0 else self.w_rest, i + 1)

    def queries(self, n: int) -> np.ndarray:
        """``n`` query rows from the serving mixture, as host numpy."""
        return self._draw(n, self.w_rest, 999).cpu().numpy()

    def chunks(self, n_rows: int) -> list[tuple[int, int]]:
        """(chunk index, rows) of the corpus's first ``n_rows``."""
        c = self.chunk_rows
        return [(i, min(c, n_rows - i * c)) for i in range(-(-n_rows // c))]

    def rows(self, ids: np.ndarray, n_rows: int) -> torch.Tensor:
        """The fp32 rows ``ids`` (host int array) of the corpus's first
        ``n_rows``, in the order given: their chunks drawn again at the
        sizes ``chunks(n_rows)`` draws them (a shorter draw is not a
        prefix of a longer one)."""
        ids = np.asarray(ids, np.int64)
        out = torch.empty((ids.shape[0], self.d), device=self.device)
        which = ids // self.chunk_rows
        sizes = dict(self.chunks(n_rows))
        for i in np.unique(which):
            at = np.nonzero(which == i)[0]
            rows = self.chunk(int(i), sizes[int(i)])[torch.from_numpy(
                ids[at] - i * self.chunk_rows).to(self.device)]
            out[torch.from_numpy(at).to(self.device)] = rows
        return out

    def exact_ip_labels(self, xq, k: int, n_rows: int) -> np.ndarray:
        """Exact fp32 inner-product top-k positions over the first
        ``n_rows``, the chunks drawn again (TF32 off); ``xq`` (nq, d)
        host numpy or a device tensor."""
        from ..ops.flat_search import exact_topk, topk_ordered
        from ..utils.config import full_fp32

        q = torch.as_tensor(xq, device=self.device)
        best_s = torch.full((q.shape[0], k), float("-inf"),
                            device=self.device)
        best_p = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                            device=self.device)
        for i, n in self.chunks(n_rows):
            with full_fp32():
                s, p = exact_topk(q @ self.chunk(i, n).T, k)
            best_s, best_p = topk_ordered(
                torch.cat([best_s, s], 1),
                torch.cat([best_p, i * self.chunk_rows + p], 1), k)
        return best_p.cpu().numpy()
