"""Time the fused pair-tile IVF,Flat searches of duckdb_faiss_ext_tpu_torch
(K7 ``csrc/ivf_pairs.cu`` and K10 ``csrc/ivf_pairs_mega.cu`` over
``csrc/pairs_tf32.cuh``) under several launch plans on one CUDA card, in
turns within one process.

    python3 tools/pairs_plans.py         # the plans, in turns
    python3 tools/pairs_plans.py wall    # faiss_search's wall time only

Shape: the IVF1024,Flat inner-product index of ``chip_smoke.py``'s phase 8
(262,144 x 1536 clustered, seed 7) at b1024, nprobe 16, k = 10, k_scan 42.
A plan sets module constants of ``ops/ivf_pairs.py`` before the launch is
planned: the rows of a share (``SHARE_ROWS``), K10's deepest ring
(``_MAX_RING``) and whether two of its blocks may share an SM (``_SM_SMEM``
0 leaves one), and whether TMA or K10's ``cp.async`` instance copies the
rows.  Each plan's results must equal the default K7 plan's exactly (no
plan changes a result).  Times are medians over six turns of CUDA events
around ten back-to-back launches: the partial alone and both launches.
``wall`` times only ``faiss_search`` on that index at b1024 under both
``pairs_impl`` values (median of ten on the host clock, in turns); it
uses nothing but the public API and ``chip_smoke.py``'s phase 8 shapes,
so it runs from an earlier tree's root too, for parent / change turns.
"""

import statistics
import sys

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402

#: (name, K10, overrides of ops/ivf_pairs.py's module constants, tma)
PLANS = [
    ("K7", False, {}, None),
    ("K7 shares of 256 rows", False, {"SHARE_ROWS": 256}, None),
    ("K7 shares of 1024 rows", False, {"SHARE_ROWS": 1024}, None),
    ("K10", True, {}, None),
    ("K10 two blocks, 2 stages", True, {"_MAX_RING": 2}, None),
    ("K10 one block, 4 stages", True, {"_SM_SMEM": 0, "_MAX_RING": 4}, None),
    ("K10 one block, 8 stages", True, {"_SM_SMEM": 0}, None),
    ("K10 cp.async", True, {}, False),
]


def launch_under(spec, args, kw):
    """A ``TopKLaunch`` planned under ``spec`` (module constants patched
    while it is planned and its tables built)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    _, mega, overrides, tma = spec
    saved = {n: getattr(k7, n) for n in overrides}
    try:
        for n, v in overrides.items():
            setattr(k7, n, v)
        return k7.TopKLaunch(*args, **kw, mega=mega, tma=tma)
    finally:
        for n, v in saved.items():
            setattr(k7, n, v)


def wall(smi, dt, cat, xq):
    """faiss_search at b1024 under "grid" and "mega", in turns."""
    import time

    params = {"nprobe": str(cs.PAIRS_NPROBE)}
    walls = {"grid": [], "mega": []}
    for r in range(11):
        for impl in (("grid", "mega") if r % 2 == 0 else ("mega", "grid")):
            dt.config.pairs_impl = impl
            try:
                t0 = time.perf_counter()
                dt.faiss_search("pairs", cs.K, xq, params, catalog=cat)
                if r:  # the first turn warms up
                    walls[impl].append(1e3 * (time.perf_counter() - t0))
            finally:
                dt.config.pairs_impl = "grid"
    cs.log(f"IVF{cs.PAIRS_NLIST} {cs.PAIRS_N}x{cs.PAIRS_D} IP nprobe "
           f"{cs.PAIRS_NPROBE} b1024 k={cs.K}: faiss_search wall "
           f"{statistics.median(walls['grid']):.3f} ms under pairs_impl "
           f"grid, {statistics.median(walls['mega']):.3f} ms under mega "
           f"(medians of 10, in turns) [{smi}]")


def main():
    import duckdb_faiss_ext_tpu_torch as dt

    smi = cs.phase_environment()
    cs.phase_build()
    xb, xq = cs.clustered_f32(cs.PAIRS_N, cs.PAIRS_D, cs.BIG_BATCH,
                              cs.PAIRS_NLIST, seed=7)
    cat = dt.Catalog()
    dt.faiss_create("pairs", cs.PAIRS_D, f"IVF{cs.PAIRS_NLIST},Flat",
                    metric_type="INNER_PRODUCT", catalog=cat)
    dt.faiss_manual_train(xb, "pairs", catalog=cat)
    dt.faiss_add(xb, "pairs", catalog=cat)
    if sys.argv[1:] == ["wall"]:
        wall(smi, dt, cat, xq)
        return
    plans(smi, cat, xq)


def plans(smi, cat, xq):
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk

    lay = cat.get("pairs").index._build_device_layout()
    q = torch.from_numpy(xq).to(cs.DEVICE)
    probe = coarse_topk(q, lay.centroids, cs.PAIRS_NPROBE, "INNER_PRODUCT")
    args = (lay.payload, lay.counts, lay.row_pos, probe, q, None)
    kw = dict(k=cs.K, k_scan=max(4 * cs.K, cs.K + 32),
              metric="INNER_PRODUCT")
    launches = {spec[0]: launch_under(spec, args, kw) for spec in PLANS}
    ref = None
    for name, launch in launches.items():
        launch.run()
        torch.cuda.synchronize()
        if ref is None:
            ref = (launch.scores.clone(), launch.positions.clone())
        cs.check(torch.equal(launch.scores, ref[0])
                 and torch.equal(launch.positions, ref[1]),
                 f"plan {name} changed a result")
    partial = {n: [] for n in launches}
    both = {n: [] for n in launches}
    for r in range(6):
        names = list(launches) if r % 2 == 0 else list(launches)[::-1]
        for n in names:
            launch = launches[n]
            partial[n].append(cs.cuda_ms(lambda: [
                launch.run(k7.PARTIAL) for _ in range(10)]) / 10)
            both[n].append(cs.cuda_ms(lambda: [
                launch.run() for _ in range(10)]) / 10)
    for n, launch in launches.items():
        p = launch.plan
        cs.log(f"pairs plan {n} (T {p['tiles']}, shares of "
               f"{p['share_rows']} rows, {p['stages']} stages, tma "
               f"{p['tma']}, {p['smem']} bytes of shared memory): partial "
               f"{statistics.median(partial[n]):.3f} ms, partial + merge "
               f"{statistics.median(both[n]):.3f} ms (medians of six turns "
               f"of CUDA events over ten launches) [{smi}]")


if __name__ == "__main__":
    main()
