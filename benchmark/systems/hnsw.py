"""An ``IDMap,HNSWm,Flat`` index of the port, built as the upstream's
``create_index`` builds its HNSW benchmark index and searched as its
benchmark searches it: ``faiss_create_params`` with the configuration's
``efConstruction``, the corpus drawn on the device chunk by chunk and
given to ``faiss_add_device`` with the passage ids (``expected_total``
rows; the rows never reach the host), the graph built by the first search,
and every call a ``faiss_search`` at the configuration's ``efSearch``.  A
port without device-resident ingest for Flat storage (no
``models.rows_device_adds`` counter in ``faiss_stats`` once the index is
created) is refused before any corpus row is drawn: its host path would
hold 54 GB of rows on the host and upload them padded."""

from __future__ import annotations

import numpy as np
import torch

import duckdb_faiss_ext_tpu_torch as dfx

#: the metric faiss_create gives an index when none is named
DEFAULT_METRIC = "INNER_PRODUCT"


class System:
    def __init__(self, cfg: dict, data, device: torch.device):
        dfx.set_device(device.type)
        dfx.set_precision(cfg["precision"])
        self.cat, self.name = dfx.Catalog(), cfg["name"]
        self.k = int(cfg["k"])
        self.params = {"efSearch": str(cfg["ef_search"])}
        self.fault_params = {"efSearch": str(cfg["fault_ef_search"])}
        named = ({} if cfg["metric"] == DEFAULT_METRIC
                 else {"metric_type": cfg["metric"]})
        create = {"efConstruction": str(cfg["ef_construction"])}
        # a configuration cut to a test's size lowers the rows from which
        # the walk serves (the port's 200,000)
        if "ann_threshold" in cfg:
            create["ann_threshold"] = str(cfg["ann_threshold"])
        dfx.faiss_create_params(self.name, int(cfg["d"]), cfg["factory"],
                                create, catalog=self.cat, **named)
        if "models.rows_device_adds" not in dfx.faiss_stats(
                catalog=self.cat)["counters"]:
            raise RuntimeError("this port has no device-resident ingest for "
                               "Flat storage, so it cannot hold the index")
        ids, row = data.ids(), 0
        for i, n in data.chunk_sizes():
            dfx.faiss_add_device(data.chunk(i), self.name, ids[row:row + n],
                                 expected_total=data.rows if i == 0 else None,
                                 catalog=self.cat)
            row += n

    def search(self, queries: np.ndarray) -> np.ndarray:
        return dfx.faiss_search(self.name, self.k, queries, self.params,
                                catalog=self.cat)

    def fault_search(self, queries: np.ndarray) -> np.ndarray:
        """A search at FAISS's default efSearch (16): a fault that
        ``benchmark/control.py`` reads the limits against, never run by a
        benchmark run."""
        return dfx.faiss_search(self.name, self.k, queries,
                                self.fault_params, catalog=self.cat)

    def state(self) -> dict:
        """The built adjacency, through the port's public read-only
        ``HNSWIndex.graph``: the reference checks that the walk can reach
        every row."""
        index = self.cat.get(self.name).index
        return {"graph": getattr(index, "inner", index).graph}

    def close(self) -> None:
        dfx.faiss_destroy(self.name, catalog=self.cat)
