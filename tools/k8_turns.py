"""Measure the IVF-PQ / IVF-RQ list search (K8) of duckdb_faiss_ext_tpu_torch
on one CUDA card, for comparisons made in turns within one chip call.

    python3 tools/k8_turns.py path      # in a checkout: its PQ / RQ paths
    python3 tools/k8_turns.py plans     # K8 under several split plans

``path`` runs the phases of the ``chip_smoke.py`` in the working directory
that the IVF-PQ cells need (environment, build, the 1M x 128 corpus, the
Flat main path for exact labels, the IDMap,IVF4096,PQ16 main path and the
IVF4096,RQ8x8 leg) and prints their lines, so that two trees can be
compared on one card: unpack the parent with ``git archive`` and run this
script from each tree's root in turn (parent, change, change, parent).

``plans`` times K8 at the PQ16 main path's b48 (64 rows) and b1024 under
each split plan of ``--blocks-per-sm`` (the partial launch's blocks aimed
at per SM, ``ops/ivf_pq_scan.py::_BLOCKS_PER_SM``), in turns, ten calls a
turn, three turns, medians of CUDA events; then each plan's device time
per launch from ``torch.profiler`` over 20 calls, and, under the
module's own plan, the host time of a call's set-up (``Launch``) and
launch (``Launch.run``).
"""

import argparse
import os
import statistics
import sys
import time


def run_path():
    import torch

    import chip_smoke as cs

    smi = cs.phase_environment()
    cs.phase_build()
    data = cs.main_path_data()
    _, _, _, exact = cs.phase_main_path(smi, data)
    torch.cuda.empty_cache()
    pq = cs.phase_pq_main(smi, data, exact)
    del pq["cat"], pq["index"]
    torch.cuda.empty_cache()
    cs.phase_rq_leg(smi, data, exact)


def device_us(fn, calls=20):
    """Device microseconds a call of each kernel fn launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("::")[-1]: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def run_plans(blocks_per_sm):
    import torch

    import chip_smoke as cs
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    smi = cs.phase_environment()
    cs.phase_build()
    data = cs.main_path_data()
    cat = dt.Catalog()
    index, lay = cs.build_coded_ivf(dt, cat, "pq", cs.PQ_FACTORY, data,
                                    data["ids"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    default = k8._BLOCKS_PER_SM
    for name, nq_pad in (("b48", 64), ("b1024", cs.BIG_BATCH)):
        _, _, args, kw, _ = cs.k8_shapes(index, lay, data[name], nq_pad)

        def call():
            return k8.ivf_pq_list_search(*args, k=cs.K, **kw)

        times = {b: [] for b in blocks_per_sm}
        for _ in range(3):
            for b in blocks_per_sm:
                k8._BLOCKS_PER_SM = b
                call()
                times[b] += [cs.cuda_ms(call) for _ in range(10)]
        for b in blocks_per_sm:
            k8._BLOCKS_PER_SM = b
            p = k8.plan(nq_pad, cs.IVF_NPROBE, cs.K, lay.payload.shape[2],
                        lay.codebooks.shape[1], n_sm)
            dev = ", ".join(f"{key} {us:.1f} us"
                            for key, us in device_us(call).items())
            print(f"K8 {name} ({nq_pad} rows) at {b} blocks an SM "
                  f"({p['splits']} splits): {statistics.median(times[b]):.3f}"
                  f" ms (median CUDA events); device a call: {dev} [{smi}]",
                  flush=True)
        k8._BLOCKS_PER_SM = default
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            launch = k8.Launch(*args, k=cs.K, **kw)
        t1 = time.perf_counter()
        for _ in range(200):
            launch.run()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"K8 {name} host time a call: set-up (Launch) "
              f"{1e3 * (t1 - t0) / 200:.3f} ms, launch (run) "
              f"{1e3 * (t2 - t1) / 200:.3f} ms [{smi}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("path", "plans"))
    ap.add_argument("--blocks-per-sm", default="8,4,2")
    opts = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    if opts.mode == "path":
        run_path()
    else:
        run_plans([int(b) for b in opts.blocks_per_sm.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
