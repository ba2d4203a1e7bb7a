"""Time the fused per-query list searches of duckdb_faiss_ext_tpu_torch (K6
IVF,Flat and K2 IVF,SQ8, ``csrc/list_topk.cuh``) under several launch
plans on one CUDA card, in turns within one process.

    python3 tools/list_topk_plans.py

Shapes: K6 over the IVF4096,Flat index of ``chip_smoke.py``'s main path
(1M x 128 clustered, L2, nprobe 64, k = 10) at b48 (64 rows) and b1024,
and over a synthetic IVF1024,Flat layout at d = 1536 (lmax 512, counts
drawn from 128 to 512, inner product, random probes of 16 lists) at b48
(64 rows); K2 over a synthetic IVF4096,SQ8 code layout at d = 1536 (lmax
1024, counts drawn from 256 to 1024, inner product, random probes of 16
lists, k = 10, k_scan 42) at b48 (64 rows).  A plan sets the module
constants of ``ops/list_topk.py`` (chunk bytes, stages a consumer warp,
consumer warps, blocks a split plan aims at an SM), K6's lanes a row, and
whether bulk copies (TMA) or the ``cp.async`` instance stage the rows.
Each plan's results must equal the default plan's exactly (no plan
changes a result), but for K6's lanes a row, which set the summation tree
of a row.  Times are medians of CUDA
events over three turns of ten calls of the two launches, with each
plan's partial launch alone beside them, and the raw launch plus torch's
top-k in the same turns for reference.
"""

import statistics
import sys

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402

#: (name, overrides of ops/list_topk.py's module constants, tma)
PLANS = [
    ("default", {}, True),
    ("bps2", {"_BLOCKS_PER_SM": 2}, True),
    ("bps8", {"_BLOCKS_PER_SM": 8}, True),
    ("6KB", {"_CHUNK_BYTES": 6 * 1024}, True),
    ("warps8", {"_WARPS": 8}, True),
    ("lanes32", {"LANES": 32}, True),
    ("cp.async", {}, False),
]


def with_plan(spec, make):
    """``make()`` under the plan ``spec`` (module constants patched)."""
    from duckdb_faiss_ext_tpu_torch.ops import list_topk as lt

    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.utils.config import next_pow2

    _, overrides, tma = spec
    overrides = dict(overrides)
    lanes = overrides.pop("LANES", None)
    saved = {n: getattr(lt, n) for n in overrides}
    saved_tma, saved_shape = lt.tma_ok, k6._shape
    if lanes:
        def shape(lists, xq):
            vec4, _ = saved_shape(lists, xq)
            d = lists.shape[2]
            return vec4, min(lanes, next_pow2(d // 4 if vec4 else d))
        k6._shape = shape
    for n, v in overrides.items():
        setattr(lt, n, v)
    if not tma:
        lt.tma_ok = lambda payload: False
    try:
        return make()
    finally:
        for n, v in saved.items():
            setattr(lt, n, v)
        lt.tma_ok, k6._shape = saved_tma, saved_shape


def turns(label, launches, before, smi):
    """Times each plan's launch (both launches, then the partial alone) and
    ``before`` in turns; checks every plan's results against the first."""
    from duckdb_faiss_ext_tpu_torch.ops import list_topk as lt

    ref = None
    for name, launch in launches:
        launch.run()
        torch.cuda.synchronize()
        got = (launch.scores.clone(), launch.positions.clone())
        if ref is None:
            ref = got
        cs.check(name == "lanes32" or (torch.equal(got[0], ref[0])
                                       and torch.equal(got[1], ref[1])),
                 f"{label}: plan {name} changes the result")
    before()
    ms = {name: [] for name, _ in launches}
    part = {name: [] for name, _ in launches}
    ms["before"] = []
    for _ in range(3):
        for name, launch in launches:
            ms[name].append(cs.cuda_ms(lambda: [launch.run()
                                                for _ in range(10)]) / 10)
            part[name].append(cs.cuda_ms(lambda: [launch.run(lt.PARTIAL)
                                                  for _ in range(10)]) / 10)
        ms["before"].append(cs.cuda_ms(lambda: [before()
                                                for _ in range(10)]) / 10)
    for name, launch in launches:
        p = launch.plan
        cs.log(f"plans {label} {name}: {statistics.median(ms[name]):.3f} ms "
               f"(partial {statistics.median(part[name]):.3f}; splits "
               f"{p['splits']}, chunk rows {p['chunk_rows']}, stages "
               f"{p['stages']}, warps {p['warps']}, tma {p['tma']}, smem "
               f"{p['smem']}) [{smi}]")
    cs.log(f"plans {label} raw launch + torch top-k: "
           f"{statistics.median(ms['before']):.3f} ms [{smi}]")


def flat(smi):
    import numpy as np

    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.utils.config import pad_rows

    data = cs.main_path_data()
    cat = dt.Catalog()
    dt.faiss_create("ivf", cs.D, "IVF4096,Flat", metric_type="L2",
                    catalog=cat)
    dt.faiss_manual_train(data["xb"][:cs.IVF_TRAIN], "ivf", catalog=cat)
    dt.faiss_add(data["xb"], "ivf", catalog=cat)
    lay = cat.get("ivf").index._build_device_layout()
    for name, nq_pad in (("b48", 64), ("b1024", cs.BIG_BATCH)):
        xq = torch.from_numpy(pad_rows(np.asarray(data[name]), nq_pad)).to(
            cs.DEVICE)
        probe = coarse_topk(xq, lay.centroids, cs.IVF_NPROBE, "L2")
        args = (lay.payload, lay.counts, lay.row_pos, probe, xq, None)
        launches = [(spec[0], with_plan(spec, lambda: k6.TopKLaunch(
            *args, k=cs.K, metric="L2"))) for spec in PLANS]
        label = f"K6 IVF4096 {cs.N}x{cs.D} L2 nprobe {cs.IVF_NPROBE} {name}"
        turns(label, launches,
              lambda: k6.ivf_list_search_raw(*args, k=cs.K, metric="L2"),
              smi)
        raw = (lay.payload, lay.counts, probe, xq, None, "L2")
        k6.ivf_list_scan(*raw)
        raw_ms = statistics.median(cs.cuda_ms(lambda: k6.ivf_list_scan(*raw))
                                   for _ in range(5))
        cs.log(f"plans {label} raw launch alone: {raw_ms:.3f} ms [{smi}]")
        del launches


def flat_1536(smi):
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6

    g = torch.Generator(device=cs.DEVICE).manual_seed(98)
    nlist, lmax, d, nq = 1024, 512, 1536, 64
    lists = torch.randn(nlist, lmax, d, device=cs.DEVICE, generator=g)
    counts = torch.randint(128, lmax + 1, (nlist,), device=cs.DEVICE,
                           generator=g, dtype=torch.int32)
    row_pos = cs.live_row_pos(counts, lmax)
    xq = torch.randn(nq, d, device=cs.DEVICE, generator=g)
    probe = cs.probe_table(g, nq, nlist, 16)
    args = (lists, counts, row_pos, probe, xq, None)
    launches = [(spec[0], with_plan(spec, lambda: k6.TopKLaunch(
        *args, k=cs.K, metric="INNER_PRODUCT"))) for spec in PLANS]
    turns(f"K6 synthetic IVF{nlist},Flat lmax {lmax} x {d} IP nprobe 16 b48",
          launches, lambda: k6.ivf_list_search_raw(
              *args, k=cs.K, metric="INNER_PRODUCT"), smi)


def sq(smi):
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2

    g = torch.Generator(device=cs.DEVICE).manual_seed(99)
    nlist, lmax, d, nq = 4096, 1024, 1536, 64
    codes = torch.randint(0, 256, (nlist, lmax, d), device=cs.DEVICE,
                          generator=g, dtype=torch.uint8)
    counts = torch.randint(256, lmax + 1, (nlist,), device=cs.DEVICE,
                           generator=g, dtype=torch.int32)
    rn = torch.rand(nlist, lmax, device=cs.DEVICE, generator=g)
    rs = torch.rand(nlist, lmax, device=cs.DEVICE, generator=g) * d * 128
    row_pos = cs.live_row_pos(counts, lmax)
    vmin = torch.randn(d, device=cs.DEVICE, generator=g)
    scale = torch.rand(d, device=cs.DEVICE, generator=g) / 40 + 1e-3
    xq = torch.randn(nq, d, device=cs.DEVICE, generator=g)
    probe = cs.probe_table(g, nq, nlist, 16)
    args = (codes, rn, rs, counts, row_pos, probe, xq, None, vmin, scale)
    kw = dict(k=cs.K, k_scan=42, metric="INNER_PRODUCT", codec="sq8")
    launches = [(spec[0], with_plan(spec, lambda: k2.TopKLaunch(*args, **kw)))
                for spec in PLANS]
    turns(f"K2 synthetic IVF{nlist},SQ8 lmax {lmax} x {d} IP nprobe 16 b48",
          launches, lambda: k2.ivf_sq_list_search_raw(*args, **kw), smi)


def main():
    smi = cs.phase_environment()
    cs.phase_build()
    flat(smi)
    torch.cuda.empty_cache()
    flat_1536(smi)
    torch.cuda.empty_cache()
    sq(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
