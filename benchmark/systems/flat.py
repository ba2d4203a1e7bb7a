"""An ``IDMap,Flat`` (or ``Flat``) index of the port, built through its
public API: the corpus drawn on the device, copied to the host once
(``faiss_add`` takes host rows) and added with the generator's labels."""

from __future__ import annotations

import numpy as np
import torch

import duckdb_faiss_ext_tpu_torch as dfx


class System:
    def __init__(self, cfg: dict, data, device: torch.device):
        dfx.set_device(device.type)
        dfx.set_precision(cfg["precision"])
        self.cat, self.name = dfx.Catalog(), cfg["name"]
        self.k, self.params = int(cfg["k"]), None
        dfx.faiss_create(self.name, int(cfg["d"]), cfg["factory"],
                         metric_type=cfg["metric"], catalog=self.cat)
        xb = torch.cat([data.chunk(i) for i, _ in data.chunk_sizes()]
                       ).cpu().numpy()
        ids = data.ids()
        dfx.faiss_add(xb if ids is None else (ids, xb), self.name,
                      catalog=self.cat)

    def search(self, queries: np.ndarray) -> np.ndarray:
        return dfx.faiss_search(self.name, self.k, queries, self.params,
                                catalog=self.cat)

    def state(self) -> dict:
        return {}

    def close(self) -> None:
        dfx.faiss_destroy(self.name, catalog=self.cat)
