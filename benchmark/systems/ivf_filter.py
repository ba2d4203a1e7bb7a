"""An ``IVFn,Flat`` index of the port searched with ``faiss_search_filter``,
built as the upstream benchmark builds and runs its own: the corpus drawn
on the device chunk by chunk, ``faiss_train_device`` on its first
``train_rows`` rows, ``faiss_add_device`` of every chunk (``expected_total``
rows, which the port holds in its unpadded list layout), the filter's side
table registered in the port's SQL engine, and every call a
``faiss_search_filter`` with the configuration's filter and ``nprobe``.
A port without the unpadded layout (no ``models.unpadded_searches``
counter in ``faiss_stats`` once the index is created) is refused before
anything is drawn: its padded layout cannot hold the index on one card."""

from __future__ import annotations

import numpy as np
import torch

import duckdb_faiss_ext_tpu_torch as dfx
from duckdb_faiss_ext_tpu_torch.sql.engine import Database

#: the metric faiss_create gives an index when none is named
DEFAULT_METRIC = "INNER_PRODUCT"


class System:
    def __init__(self, cfg: dict, data, device: torch.device):
        dfx.set_device(device.type)
        dfx.set_precision(cfg["precision"])
        self.cat, self.name = dfx.Catalog(), cfg["name"]
        self.k, self.filter = int(cfg["k"]), cfg["filter"]
        self.params = {"nprobe": str(cfg["nprobe"])}
        named = ({} if cfg["metric"] == DEFAULT_METRIC
                 else {"metric_type": cfg["metric"]})
        dfx.faiss_create_params(self.name, int(cfg["d"]), cfg["factory"],
                                None, catalog=self.cat, **named)
        if "models.unpadded_searches" not in dfx.faiss_stats(
                catalog=self.cat)["counters"]:
            raise RuntimeError("this port has no unpadded list layout, and "
                               "its padded one cannot hold the index")
        want, rows = int(cfg["train_rows"]), []
        for i, n in data.chunk_sizes():
            have = sum(r.shape[0] for r in rows)
            if have >= want:
                break
            rows.append(data.chunk(i)[:want - have])
        dfx.faiss_train_device(torch.cat(rows), self.name, catalog=self.cat)
        del rows
        for i, _ in data.chunk_sizes():
            dfx.faiss_add_device(data.chunk(i), self.name,
                                 expected_total=data.rows if i == 0 else None,
                                 catalog=self.cat)
        self.db = Database()
        self.db.register(self.filter["table"], data.table())

    def search(self, queries: np.ndarray) -> np.ndarray:
        return self._search(queries, self.params)

    def _search(self, queries, params) -> np.ndarray:
        f = self.filter
        return dfx.faiss_search_filter(
            self.name, self.k, queries, f["where"], f["idselector"],
            f["table"], params, catalog=self.cat, database=self.db)

    def fault_search(self, queries: np.ndarray) -> np.ndarray:
        """A search one probe short: a fault that ``benchmark/control.py``
        reads the limits against, never run by a benchmark run."""
        return self._search(queries, {
            "nprobe": str(int(self.params["nprobe"]) - 1)})

    def state(self) -> dict:
        """The index's centroid table, through the port's public accessor:
        what the reference cannot work out again bit for bit (k-means)."""
        index = self.cat.get(self.name).index
        index = getattr(index, "inner", index)
        return {"centroids": np.array(index.centroids, np.float32)}

    def close(self) -> None:
        dfx.faiss_destroy(self.name, catalog=self.cat)
