"""Compression-pipeline showcase: OPQ rotation → IVF partition → PQ codes
→ exact RFlat re-rank, compared against the exact Flat oracle.

Demonstrates the full factory grammar on one workload:

    Flat                      — exact oracle, 4·d bytes/vector
    IVF64,PQ16                — 16 bytes/vector (32× compression at d=128)
    OPQ16,IVF64,PQ16          — + learned rotation (better codes)
    OPQ16,IVF64,PQ16,RFlat    — + exact re-rank of the candidates

    python -m duckdb_faiss_ext_tpu_torch.examples.compression_pipeline [--cpu]
"""

import sys
import time

import numpy as np

from .. import api
from ..catalog import Catalog
from ._common import parser, select_device

D, NQ, K = 128, 64, 10

CONFIGS = [
    ("IVF64,PQ16", {"nprobe": "16"}),
    ("OPQ16,IVF64,PQ16", {"nprobe": "16"}),
    ("OPQ16,IVF64,PQ16,RFlat", {"nprobe": "16", "k_factor": "8"}),
]


def main(argv=None) -> int:
    args = parser(__doc__, 50_000).parse_args(argv)
    select_device(args)
    n = args.n
    rng = np.random.default_rng(0)
    # Anisotropic, clustered data — the regime real embeddings live in.
    scales = np.linspace(2.5, 0.2, D).astype(np.float32)
    centers = rng.standard_normal((64, D)).astype(np.float32) * scales * 2
    xb = (centers[rng.integers(0, 64, n)]
          + rng.standard_normal((n, D)).astype(np.float32) * scales)
    xq = (centers[rng.integers(0, 64, NQ)]
          + rng.standard_normal((NQ, D)).astype(np.float32) * scales)

    cat = Catalog()
    api.faiss_create("oracle", D, "Flat", metric_type="L2", catalog=cat)
    api.faiss_add(xb, "oracle", catalog=cat)
    truth = api.faiss_search("oracle", K, xq, catalog=cat)

    print(f"{'factory':34s} {'recall@10':>9s} {'build s':>8s} "
          f"{'search ms':>9s}")
    for desc, params in CONFIGS:
        name = desc.replace(",", "_")
        t0 = time.time()
        api.faiss_create(name, D, desc, metric_type="L2", catalog=cat)
        api.faiss_add(xb, name, catalog=cat)
        build = time.time() - t0
        res = api.faiss_search(name, K, xq, params, catalog=cat)   # warm
        t0 = time.time()
        res = api.faiss_search(name, K, xq, params, catalog=cat)
        ms = (time.time() - t0) * 1e3
        recall = np.mean([
            len(set(res["label"][q]) & set(truth["label"][q])) / K
            for q in range(NQ)])
        print(f"{desc:34s} {recall:9.3f} {build:8.1f} {ms:9.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
