"""An ``IVFn,Flat`` index of the port, built through its public API as a
DuckDB user builds one: the corpus drawn on the device, copied to the host
once, and given to ``faiss_add`` with the generator's labels, which trains
the coarse quantizer on it (deferred training) and fills the lists; then
searched with the configuration's ``nprobe``."""

from __future__ import annotations

import numpy as np

from . import flat


class System(flat.System):
    def __init__(self, cfg: dict, data, device):
        super().__init__(cfg, data, device)
        self.params = {"nprobe": str(cfg["nprobe"])}

    def fault_search(self, queries: np.ndarray) -> np.ndarray:
        """A search one probe short: a fault that ``benchmark/control.py``
        reads the limits against, never run by a benchmark run."""
        return flat.dfx.faiss_search(
            self.name, self.k, queries,
            {"nprobe": str(int(self.params["nprobe"]) - 1)}, catalog=self.cat)

    def state(self) -> dict:
        """The index's centroid table: what the reference cannot work out
        again bit for bit (k-means)."""
        index = self.cat.get(self.name).index
        return {"centroids": np.array(index._centroids, np.float32)}
