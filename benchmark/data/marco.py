"""The MS MARCO stand-in: 8,841,823 x 1536 unit-norm rows, drawn on the
device, and the upstream benchmark's filter table.

A frozen copy of the port's ``tools/marco_corpus.py::MarcoCorpus`` in its
``"skewed"`` mixture (4,096 unit-norm centres with log-normal weights, the
first chunk's weights drifted from the rest's as a corpus's first slice
is, isotropic noise of norm 0.8 around them, each row normalised), so that
an edit to the tool cannot move the benchmark.  Each chunk of
``chunk_rows`` is a stream of its own, so any chunk can be drawn again
alone.  The corpus comes from the configuration's ``corpus_seed`` (the
index, its k-means and its list lengths are the same work on every run, as
one deployment over one dataset is); the queries come from the run's seed,
drawn from the serving mixture.  Rows carry no labels: the upstream's
``IVF2048_HNSW128,Flat`` has no IDMap, so a row's label is its position.

``table()`` is the side table of the upstream's ``run_sel`` benchmark,
``ids(i, sel = i % 100)`` (go/benches_c.go:31), over every row.  The
embeddings themselves (MS MARCO passage, ada-002) are not in the
repository; the shape, the unit norm and the uneven clusters are theirs.
"""

from __future__ import annotations

import numpy as np
import torch

#: skewed mixture: log-weight spread, the first chunk's drift, noise norm
SIGMA, DRIFT, NOISE = 0.7, 0.5, 0.8
#: the stream of the query draw (chunk i draws stream i + 1)
QUERY_STREAM = 999


class Data:
    def __init__(self, cfg: dict, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.corpus_seed = int(cfg["corpus_seed"])
        self.rows, self.d = int(cfg["rows"]), int(cfg["d"])
        self.chunk_rows = int(cfg["chunk_rows"])
        self.modulus = int(cfg["filter"]["modulus"])
        g = torch.Generator(device=self.device).manual_seed(self.corpus_seed)
        centers = int(cfg["centers"])
        self.centers = torch.nn.functional.normalize(
            torch.randn(centers, self.d, device=self.device, generator=g),
            dim=1)
        logw = torch.randn(centers, device=self.device, generator=g) * SIGMA
        drift = torch.randn(centers, device=self.device, generator=g) * DRIFT
        self.w_train = torch.softmax(logw, 0)
        self.w_rest = torch.softmax(logw + drift, 0)
        self.noise = NOISE / self.d ** 0.5

    def _draw(self, n: int, weights, stream: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(
            seed * 1000 + stream)
        c = torch.multinomial(weights, n, replacement=True, generator=g)
        x = self.centers[c] + torch.randn(
            n, self.d, device=self.device, generator=g) * self.noise
        return torch.nn.functional.normalize(x, dim=1)

    def chunk_sizes(self) -> list[tuple[int, int]]:
        c = self.chunk_rows
        return [(i, min(c, self.rows - i * c))
                for i in range(-(-self.rows // c))]

    def chunk(self, i: int) -> torch.Tensor:
        """Rows [i·chunk_rows, i·chunk_rows + n_i) on the device, fp32."""
        return self._draw(dict(self.chunk_sizes())[i],
                          self.w_train if i == 0 else self.w_rest, i + 1,
                          self.corpus_seed)

    def queries(self, n: int) -> np.ndarray:
        """``n`` query rows from the serving mixture, host numpy fp32."""
        return self._draw(n, self.w_rest, QUERY_STREAM,
                          self.seed).cpu().numpy()

    def ids(self) -> None:
        """No labels: a row's label is its position."""
        return None

    def table(self) -> dict:
        """The filter's side table ``ids(i, sel = i % modulus)``, host
        int64 columns over every row's label."""
        i = np.arange(self.rows, dtype=np.int64)
        return {"i": i, "sel": i % self.modulus}
