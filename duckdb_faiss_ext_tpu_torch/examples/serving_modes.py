"""Serving-mode tour: precision, reranks, the int8 SQ scan, batched
serving, and autotuning — the knobs that trade throughput for exactness.

    python -m duckdb_faiss_ext_tpu_torch.examples.serving_modes [--cpu]

On the card, fast mode lets the plain torch paths' fp32 matmuls run on
TF32 tensor cores; the hand-written kernels return fp32 results in both
modes.  On the CPU both modes compute in fp32.
"""

import sys
import time

import numpy as np

from .. import api
from ..catalog import Catalog
from ..harness import autotune_index, recall_at_k
from ..utils.config import set_precision, set_sq_dot
from ._common import parser, select_device

D, NQ, K = 96, 256, 10


def main(argv=None) -> int:
    args = parser(__doc__, 200_000).parse_args(argv)
    select_device(args)
    n = args.n
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((256, D)).astype(np.float32) * 4
    xb = (centers[rng.integers(0, 256, n)]
          + rng.standard_normal((n, D)).astype(np.float32))
    xq = (centers[rng.integers(0, 256, NQ)]
          + rng.standard_normal((NQ, D)).astype(np.float32))
    cat = Catalog()

    def bench(fn, reps=3):
        fn()                                    # warm up
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return out, reps * NQ / (time.perf_counter() - t0)

    try:
        # Exact ground truth (parity precision: TF32 off).
        api.faiss_create("flat", D, "Flat", metric_type="L2", catalog=cat)
        api.faiss_add(xb, "flat", catalog=cat)
        gt, qps = bench(lambda: api.faiss_search("flat", K, xq, catalog=cat))
        print(f"Flat parity (fp32-exact):            {qps:7.0f} qps")

        set_precision("fast")
        fast, qps = bench(lambda: api.faiss_search("flat", K, xq,
                                                   catalog=cat))
        print(f"Flat fast:                           {qps:7.0f} qps  "
              f"recall@10 {recall_at_k(fast['label'], gt['label'], K):.3f}")

        # Fast + rerank param: a widened scan + fp32 re-score.
        rr, qps = bench(lambda: api.faiss_search("flat", K, xq,
                                                 {"rerank": "true"},
                                                 catalog=cat))
        print(f"Flat fast + rerank:                  {qps:7.0f} qps  "
              f"recall@10 {recall_at_k(rr['label'], gt['label'], K):.3f}")

        # Batched serving: many batches dispatched, ONE packed fetch.
        _, qps = bench(lambda: api.faiss_search_batched(
            "flat", K, xq, batch_size=64, catalog=cat))
        print(f"Flat fast batched (4×b64, 1 fetch):  {qps:7.0f} qps")

        # SQ8: 4× less memory; fast mode runs the int8 scan.
        api.faiss_create("sq", D, "SQ8", metric_type="L2", catalog=cat)
        api.faiss_add(xb, "sq", catalog=cat)
        s8, qps = bench(lambda: api.faiss_search("sq", K, xq, catalog=cat))
        print(f"SQ8 fast (int8 scan):                {qps:7.0f} qps  "
              f"recall@10 {recall_at_k(s8['label'], gt['label'], K):.3f}")
        set_sq_dot("decode")
        sd, qps = bench(lambda: api.faiss_search("sq", K, xq, catalog=cat))
        print(f"SQ8 fast (decode path, set_sq_dot):  {qps:7.0f} qps  "
              f"recall@10 {recall_at_k(sd['label'], gt['label'], K):.3f}")
        set_sq_dot("auto")

        # IVF: the list scans run the hand-written kernels on the card.
        api.faiss_create("ivf", D, "IVF512,Flat", metric_type="L2",
                         catalog=cat)
        api.faiss_add(xb, "ivf", catalog=cat)
        iv, qps = bench(lambda: api.faiss_search("ivf", K, xq,
                                                 {"nprobe": "32"},
                                                 catalog=cat))
        print(f"IVF512 fast nprobe=32:               {qps:7.0f} qps  "
              f"recall@10 {recall_at_k(iv['label'], gt['label'], K):.3f}")

        # Autotune: cheapest setting reaching a recall target vs its own
        # exhaustive scan (ParameterSpace/OperatingPoints analogue).
        res = autotune_index("ivf", xq[:64], k=K, target_recall=0.95,
                             catalog=cat, repeat=1)
        print("\nautotune (IVF512):")
        print(res)
    finally:
        set_sq_dot("auto")
        set_precision("parity")
    return 0


if __name__ == "__main__":
    sys.exit(main())
