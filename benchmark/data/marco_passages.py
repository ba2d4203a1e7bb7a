"""The MS MARCO stand-in of ``marco.py`` as an IDMap deployment ingests it:
the same frozen corpus (8,841,823 x 1536 unit-norm rows from the
configuration's ``corpus_seed``, drawn on the device chunk by chunk) and
queries from the run's seed, each row labelled with its passage id, 0 …
n − 1 in ingest order, which the system hands ``faiss_add_device`` beside
the rows.  The configuration has no filter, so there is no side table."""

from __future__ import annotations

import numpy as np

from . import marco


class Data(marco.Data):
    def __init__(self, cfg: dict, seed: int, device):
        # marco.Data sizes the filter's side table from the configuration;
        # this corpus has none
        super().__init__({**cfg, "filter": {"modulus": 1}}, seed, device)

    def ids(self) -> np.ndarray:
        """The passage ids: row i is passage i."""
        return np.arange(self.rows, dtype=np.int64)

    def table(self) -> dict:
        raise ValueError("the HNSW deployment has no filter table")
