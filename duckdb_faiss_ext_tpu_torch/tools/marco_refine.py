"""Exact-rerank (refine) tier at the MS MARCO scale.

The reference's headline index stores raw fp32 vectors (HNSW,Flat), so its
recall ceiling is 1.0; a compressed IVF,SQ index caps at what its codes
keep.  faiss answers with IndexRefineFlat (the ``RFlat`` suffix): k ·
k_factor candidates from the compressed base, rescored against the raw
rows.  At 8,841,823 x 1536 the raw rows take 54.3 GB in fp32; this tool
keeps them in fp16 on the card (25.3 GiB beside the base's codes on the
80 GB H100), drawn again chunk by chunk from the corpus's seed
(tools/marco_corpus.py), and reranks the base's candidates there with
``models/refine.py::rerank`` (fp16 rows times fp32 queries promote to fp32
elementwise: no TF32).

The base index comes from tools/marco_device.py::build (``--storage``,
SQ6 by default as in the JAX tool; inner product, assign_topk 4); the
ground truth is exact fp32 search over the regenerated rows
(``MarcoCorpus.exact_ip_labels``).  Prints, for each nprobe and k_factor:
recall@10 after the rerank, the base's recall@10, and queries/s at b1024
with the rerank included (best of 3, ending on the host); then the card's
memory peak.

    python -m duckdb_faiss_ext_tpu_torch.tools.marco_refine [--storage SQ6] \\
        [--n 8841823] [--d 1536] [--seed 11] [--nprobes 16,64] \\
        [--kfactors 4,8,16] [--nq 256] [--cpu]

The JAX tool fetched its fp16 store to the host once (27 GiB through its
relay), cached it on disk and reranked in numpy, and read its queries and
ground truth from a cached file; neither cache is kept here.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import api
from ..models.refine import rerank
from ..utils.config import set_precision
from ._cli import select_device
from .marco_device import NAME, add_build_flags, build, sync


def fp16_store(corpus, n: int) -> torch.Tensor:
    """The corpus's first ``n`` rows as fp16 (n, d) on its device, drawn
    again chunk by chunk."""
    store = torch.empty((n, corpus.d), dtype=torch.float16,
                        device=corpus.device)
    c = corpus.chunk_rows
    for i, m in corpus.chunks(n):
        store[i * c:i * c + m] = corpus.chunk(i, m).half()
    return store


def recall(labels, gt, k: int) -> float:
    return float(np.mean([len(set(a[a >= 0]) & set(b[:k])) / k
                          for a, b in zip(labels, gt)]))


def refine_sweep(cat, corpus, xq, gt, nprobes, kfactors, *, store=None,
                 name: str = NAME, k: int = 10, batch: int = 1024,
                 log=print):
    """Recall@k and queries/s of the base index ``name`` (labels = corpus
    rows) with and without the exact rerank from the fp16 store (built
    from ``corpus`` when not given).  Returns one dict an (nprobe,
    k_factor): ``recall``, ``base_recall``, ``qps`` (b``batch``, rerank
    included), and the reranked ``labels`` / ``distances`` of ``xq``."""
    index = cat.get(name).index
    metric = index.metric.name
    if store is None:
        store = fp16_store(corpus, index.ntotal)
    dev = store.device
    xq_t = torch.as_tensor(xq, device=dev)
    big = xq[np.arange(batch) % xq.shape[0]]
    big_t = torch.as_tensor(big, device=dev)

    def refined(queries, queries_t, kb, params):
        res = api.faiss_search(name, kb, queries, params, catalog=cat)
        dist, pos = rerank(store, torch.from_numpy(res["label"]).to(dev),
                           queries_t, k, metric)
        return dist.cpu().numpy(), pos.cpu().numpy()

    log(f"{'nprobe':>7} {'k_factor':>9} {'recall@10':>10} "
        f"{'base r@10':>10} {'qps b' + str(batch):>10}")
    rows = []
    for nprobe in nprobes:
        params = {"nprobe": str(nprobe)}
        base = api.faiss_search(name, k, xq, params, catalog=cat)
        base_rec = recall(base["label"], gt, k)
        for kf in kfactors:
            kb = k * kf
            dist, lab = refined(xq, xq_t, kb, params)
            refined(big, big_t, kb, params)             # warm the shape
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                refined(big, big_t, kb, params)
                sync(dev)
                best = min(best, time.perf_counter() - t0)
            row = {"nprobe": nprobe, "k_factor": kf,
                   "recall": recall(lab, gt, k), "base_recall": base_rec,
                   "qps": batch / best, "labels": lab, "distances": dist}
            rows.append(row)
            log(f"{nprobe:>7} {kf:>9} {row['recall']:10.4f} "
                f"{base_rec:10.4f} {row['qps']:10.1f}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_build_flags(ap)
    ap.set_defaults(storage="SQ6")
    ap.add_argument("--nprobes", default="16,64")
    ap.add_argument("--kfactors", default="4,8,16")
    ap.add_argument("--nq", type=int, default=256,
                    help="queries with exact labels")
    args = ap.parse_args(argv)
    select_device(args)
    log = lambda m: print(m, flush=True)  # noqa: E731
    cat, corpus, _ = build(args, log=log)
    xq = corpus.queries(args.nq)
    t0 = time.perf_counter()
    gt = corpus.exact_ip_labels(xq, 10, args.n)
    log(f"exact labels of {args.nq} queries: "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    store = fp16_store(corpus, args.n)
    sync(store.device)
    log(f"fp16 refine store {args.n}x{args.d} on the {store.device.type}: "
        f"{store.numel() * 2 / 2**30:.1f} GiB in "
        f"{time.perf_counter() - t0:.1f}s")
    log(f"\n=== refine tier ({args.storage} base + fp16 rerank on the "
        f"{store.device.type}) ===")
    set_precision("fast")
    try:
        refine_sweep(cat, corpus, xq, gt,
                     [int(p) for p in args.nprobes.split(",")],
                     [int(f) for f in args.kfactors.split(",")],
                     store=store, log=log)
    finally:
        set_precision("parity")
    if store.device.type == "cuda":
        log(f"card memory peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")
    print("MARCO-REFINE COMPLETE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
