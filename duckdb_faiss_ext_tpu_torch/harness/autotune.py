"""Search-parameter auto-tuning — the analogue of FAISS core's
``ParameterSpace`` / ``OperatingPoints`` (faiss/AutoTune.h).

The reference extension exposes no auto-tuning; FAISS itself does, and its
users lean on it to pick ``nprobe``/``efSearch``.  This brings the
capability to the rebuild at the harness tier: sweep the index's main
search knob, measure (recall@k, QPS) per setting against the index's own
exhaustive search, keep the Pareto frontier, and report the cheapest
setting that reaches a target recall.  The output is a parameter MAP that
the existing ``faiss_search`` accepts verbatim — no new SQL surface.

A copy of ``duckdb_faiss_ext_tpu/harness/autotune.py`` without its graph
(efSearch) sweep, which waits for the port's HNSW / NSG.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import api
from ..catalog import Catalog
from .recall import recall_at_k


@dataclasses.dataclass
class OperatingPoint:
    params: dict[str, str]     # pass straight to faiss_search
    recall: float              # recall@k vs the exhaustive search
    qps: float                 # queries/s through the public API
    pareto: bool = False       # on the recall/QPS frontier


@dataclasses.dataclass
class AutotuneResult:
    points: list[OperatingPoint]
    best: OperatingPoint | None     # cheapest point with recall ≥ target
    target_recall: float
    k: int

    def __str__(self) -> str:
        lines = [f"operating points (k={self.k}, target recall "
                 f"{self.target_recall:.2f}):"]
        for p in self.points:
            mark = "*" if p.pareto else " "
            best = "  <- best" if p is self.best else ""
            lines.append(f" {mark} {p.params or '{}'}: recall "
                         f"{p.recall:.3f}, {p.qps:.0f} qps{best}")
        return "\n".join(lines)


def _unwrap(index):
    # IDMap/PreTransform wrap via .inner; RefineFlat via .base.
    while True:
        nxt = getattr(index, "inner", None) or getattr(index, "base", None)
        if nxt is None:
            return index
        index = nxt


def _default_grid(index) -> tuple[list[dict[str, str]], dict[str, str]]:
    """(settings to sweep, exhaustive ground-truth params) for the index's
    main search knob.  Knobless families (Flat/PQ/SQ/RQ) scan exhaustively
    already — one empty setting."""
    inner = _unwrap(index)
    nlist = getattr(inner, "nlist", None)
    if nlist:
        vals, v = [], 1
        while v < nlist:
            vals.append(v)
            v *= 2
        vals.append(nlist)
        return ([{"nprobe": str(x)} for x in vals],
                {"nprobe": str(nlist)})
    return [{}], {}


def autotune_index(name: str, xq, k: int = 10, target_recall: float = 0.9,
                   grid: list[dict[str, str]] | None = None,
                   catalog: Catalog | None = None,
                   repeat: int = 3) -> AutotuneResult:
    """Sweep search settings for index ``name`` over query batch ``xq``.

    ``grid`` overrides the default single-knob sweep with explicit
    parameter maps.  Ground truth is the index's own exhaustive search
    (``nprobe=nlist`` for IVF — FAISS AutoTune's convention), so recall
    measures the knob's pruning loss, not the codec's quantization loss."""
    xq = np.asarray(xq, dtype=np.float32)
    cat = catalog if catalog is not None else api.GLOBAL_CATALOG
    entry = cat.get(name)
    # Ground truth always comes from the index's exhaustive knob setting,
    # whether the sweep grid is the default or caller-supplied.
    default_settings, gt_params = _default_grid(entry.index)
    settings = grid if grid is not None else default_settings

    gt = api.faiss_search(name, k, xq, gt_params or None, catalog=cat)
    gt_labels = gt["label"]

    points: list[OperatingPoint] = []
    for params in settings:
        res = api.faiss_search(name, k, xq, params or None, catalog=cat)
        best_dt = float("inf")
        for _ in range(max(1, repeat)):
            t0 = time.perf_counter()
            api.faiss_search(name, k, xq, params or None, catalog=cat)
            best_dt = min(best_dt, time.perf_counter() - t0)
        points.append(OperatingPoint(
            params=dict(params),
            recall=recall_at_k(res["label"], gt_labels, k),
            qps=len(xq) / best_dt))

    # Pareto frontier: a point survives if no other point has both higher
    # recall and higher QPS.
    for p in points:
        p.pareto = not any(q.recall > p.recall and q.qps > p.qps
                           for q in points)
    reaching = [p for p in points if p.recall >= target_recall]
    best = max(reaching, key=lambda p: p.qps) if reaching else None
    return AutotuneResult(points=points, best=best,
                          target_recall=target_recall, k=k)
