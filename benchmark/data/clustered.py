"""The clustered 1M x 128 stand-in for SIFT1M, drawn on the device.

A frozen copy of the port's ``harness/datasets.py::synthetic_dataset``
(``ncl`` centres N(0, 16·I), each row a centre plus N(0, I) noise, queries
drawn near the same centres), with two changes: the draw runs on the
device with ``torch.Generator`` in chunks of ``chunk_rows`` (each chunk a
stream of its own, so any chunk can be drawn again alone), and the rows
carry int64 labels, a seeded permutation of [0, n) shifted by
``LABEL_BASE`` (so that ``IDMap`` has to map every position).  The centres
come from the configuration's ``data_seed``, the labels and queries from
the run's seed: every seed draws the same clusters.  The rows come from
the run's seed too, unless the configuration names a ``corpus_seed``: then
every run holds the same corpus, as a deployment over one dataset does, so
that an index whose work follows its data (an IVF's list lengths, set by
its k-means) does the same work on every seed.  The SIFT files are not
in the repository; the shape and the clustering are SIFT1M's (1,000,000 x
128, queries near the data).
"""

from __future__ import annotations

import numpy as np
import torch

#: labels start here: beyond 32 bits, so a label path that narrows shows
LABEL_BASE = 1 << 40
#: the centres' scale (synthetic_dataset's ``* 4.0``)
CENTER_SCALE = 4.0


class Data:
    def __init__(self, cfg: dict, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.corpus_seed = int(cfg.get("corpus_seed", seed))
        self.rows, self.d = int(cfg["rows"]), int(cfg["d"])
        self.chunk_rows = int(cfg["chunk_rows"])
        g = torch.Generator(device=self.device).manual_seed(
            int(cfg["data_seed"]))
        self.centers = torch.randn(int(cfg["centers"]), self.d,
                                   device=self.device,
                                   generator=g) * CENTER_SCALE

    def _draw(self, n: int, stream: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(
            seed * 1000 + stream)
        c = torch.randint(0, self.centers.shape[0], (n,), device=self.device,
                          generator=g)
        return self.centers[c] + torch.randn(n, self.d, device=self.device,
                                             generator=g)

    def chunk_sizes(self) -> list[tuple[int, int]]:
        c = self.chunk_rows
        return [(i, min(c, self.rows - i * c))
                for i in range(-(-self.rows // c))]

    def chunk(self, i: int) -> torch.Tensor:
        """Rows [i·chunk_rows, i·chunk_rows + n_i) on the device, fp32."""
        return self._draw(dict(self.chunk_sizes())[i], i + 1,
                          self.corpus_seed)

    def queries(self, n: int) -> np.ndarray:
        """``n`` query rows near the centres, host numpy fp32."""
        return self._draw(n, 999, self.seed).cpu().numpy()

    def ids(self) -> np.ndarray:
        """The label of every row, host int64."""
        g = torch.Generator(device=self.device).manual_seed(
            self.seed * 1000 + 998)
        perm = torch.randperm(self.rows, device=self.device, generator=g)
        return perm.cpu().numpy().astype(np.int64) + LABEL_BASE
