"""Measured pairs-vs-per-query dispatch gate for the IVF list scans.

A copy of ``duckdb_faiss_ext_tpu/ops/pairs_gate.py`` with rows measured on
the H100.  The pair-tile searches (K3 / K9 for SQ, ops/ivf_sq_pairs.py;
K7 / K10 for Flat, ops/ivf_pairs.py) read each probed list once for all
the queries that probe it; the per-query searches (K2, ops/ivf_sq_scan.py;
K6, ops/ivf_list_scan.py) read it once a query but need no pair table, no
gather of the pair rows and no torch top-k after the scan.  Which wins
depends on the per-pair dot work lmax*d and on how many queries share a
list.  ``MEASURED`` holds the card's ratio t(per-query) / t(pair tiles) at
the JAX grid's 14 shapes, and ``pairs_preferred`` interpolates it in
(log2(lmax*d), log2(nq), 0.5*log2(d)).  Outside the measured hull the
caller's static rule decides.
"""

from __future__ import annotations

import math

# (lmax*d, nq, d, speedup): speedup = t(fused K2 search) / t(K3 pair-tile
# search, mega=False), medians of 10 CUDA-event timings taken in turns by
# ``python -m duckdb_faiss_ext_tpu_torch.tools.pairs_crossover`` (sq8, IP,
# nlist 1024, nprobe 16, k 10, k_scan 42, full lists, random probes) on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit.  Grid: (lmax, d) in
# {(512..4096, 128), (1024, 768), (512..2048, 1536)} x nq in {256, 1024}.
# The fused K2 keeps each query's best rows in its partial launch, while
# the pair tiles write a raw score block that a gather and a torch top-k
# read again: the tiles win only where a list's bytes, read once for all
# its queries, outweigh that (d >= 768 at b1024, the marco shape at b256).
MEASURED: list[tuple[int, int, int, float]] = [
    (65536, 256, 128, 0.32),
    (65536, 1024, 128, 0.41),
    (262144, 256, 128, 0.43),
    (262144, 1024, 128, 0.49),
    (524288, 256, 128, 0.51),
    (524288, 1024, 128, 0.51),
    (786432, 256, 768, 0.70),
    (786432, 1024, 768, 1.24),
    (786432, 256, 1536, 0.78),
    (786432, 1024, 1536, 1.22),
    (1572864, 256, 1536, 0.73),
    (1572864, 1024, 1536, 1.89),
    (3145728, 256, 1536, 1.20),
    (3145728, 1024, 1536, 2.49),  # nearest row to the marco serving shape
]

#: static floors that measurements do not override
MIN_BATCH_FLOOR = 64
MIN_WORK_FLOOR = 1 << 16


def _features(work: int, nq: int, d: int) -> tuple[float, float, float]:
    # d enters at half weight: it separates equal-work configs without
    # dominating the (work, nq) surface.
    return (math.log2(max(work, 1)), math.log2(max(nq, 1)),
            0.5 * math.log2(max(d, 1)))


def pairs_speedup_estimate(work: int, nq: int, d: int = 0,
                           table=None) -> tuple[float, float]:
    """Inverse-distance-weighted geometric mean of measured speedups.

    Returns (estimate, hull_distance): hull_distance is the feature-space
    distance to the nearest measured point; callers treat estimates
    further than 2 octaves from any measurement as unreliable.
    """
    rows = MEASURED if table is None else table
    if not rows:
        return 1.0, float("inf")
    if d <= 0:
        d = max(1, work // 2048)       # 2-argument callers: assume a
    fx, fy, fz = _features(work, nq, d)  # mid-size lmax
    num = den = 0.0
    dmin = float("inf")
    for row in rows:
        w, n, rd, s = row if len(row) == 4 else (*row[:2], 0, row[2])
        gx, gy, gz = _features(w, n, rd if rd > 0 else max(1, w // 2048))
        d2 = (fx - gx) ** 2 + (fy - gy) ** 2 + (fz - gz) ** 2
        dmin = min(dmin, math.sqrt(d2))
        wgt = 1.0 / (d2 + 1e-6)
        num += wgt * math.log(max(s, 1e-6))
        den += wgt
    return math.exp(num / den), dmin


def pairs_preferred(work: int, nq: int, d: int = 0, *, table=None,
                    static_ok: bool | None = None) -> bool:
    """Should the pair-tile path run at (lmax*d = work, batch nq)?

    Inside the measured hull (nearest measurement within 2 octaves) the
    interpolated speedup decides, with a 5% hysteresis so that a shape
    near 1.0 does not switch paths between rebuilds.  Outside it the
    caller's static rule (``static_ok``) decides, by default the rule
    lmax*d >= 2**19 and nq >= 256.
    """
    if nq < MIN_BATCH_FLOOR or work < MIN_WORK_FLOOR:
        return False
    est, dist = pairs_speedup_estimate(work, nq, d, table)
    if dist <= 2.0:
        return est >= 1.05
    if static_ok is None:
        static_ok = work >= (1 << 19) and nq >= 256
    return static_ok
