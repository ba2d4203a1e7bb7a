"""The reference's headline index family at its own benchmark scale: a
graph walk (HNSW128's counterpart) over 8,841,823 x 1536.

The reference benchmarks ``IDMap,HNSW128,Flat`` over MS MARCO ada-002
(go/cmd/create_index/main.go:29, Makefile:93).  54.3 GB of fp32 rows and
the build's carry do not fit one 80 GB card beside anything else, so the
build and the walk read SQ codes (ops/graph.py's coded paths), as the JAX
package's tools/marco_graph.py does:

  phase 1  two ``--half-k``-way k-means over the two halves of the
           dimensions on ``--train-rows`` rows: ``half_k``² product cells
           (the IMI trick: 32,761 build cells for the training cost of
           two 181-way k-means);
  phase 2  the corpus (tools/marco_corpus.py) drawn on the card chunk by
           chunk, encoded as sq4 (6.8 GB at 8.8M rows) and assigned to its
           exact top-2 product cells;
  phase 3  the coded clustered k-NN scan at ``--inter`` degree over the
           top-2 membership table (``--lmax-factor`` sizes the cells), then
           ``--refine-rounds`` coded NN-descent rounds (``--descent-sample``
           neighbours of each neighbour) and ``augment_graph`` to ``--deg``
           (forward edges first, reverse edges backfill);
  phase 4  the sq4 buffer freed, the corpus drawn again and encoded in the
           serve codec (sq8: 13.6 GB, sq6: 10.2 GB);
  phase 5  the walk at each pool (efSearch) of ``--pools`` and each batch
           of ``--batches``, recall@10 against exact fp32 search over
           regenerated chunks.

With ``--edge-sample`` rows (default 1,024) the k-NN graph's edge recall
before ``augment_graph`` is measured against each sampled row's exact
``--inter`` nearest rows, found by the Flat kernel K1 over the regenerated
fp32 rows.  Each phase prints its seconds and the card's memory peak.

    python -m duckdb_faiss_ext_tpu_torch.tools.marco_graph \\
        [--n 8841823] [--deg 64] [--inter 64] [--lmax-factor 3.0] \\
        [--refine-rounds 0] [--serve-codec sq6] [--cpu]

Runs on the card unless ``--cpu`` is given (then at a small ``--n`` and
``--d``).  Queries: the corpus's serving draw (``serving_queries``), so
b48 and b1024 are the batches ``chip_smoke.py`` phases 16 and 27 search.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import flat_topk as ft
from ..ops import graph as graph_ops
from ..ops.flat_search import exact_topk, finalize_scores, topk_ordered
from ..ops.kmeans import kmeans_fit
from ..ops.sq import SQ_LEVELS, sq_pack_t, sq_quantize, sq_train
from ..utils.config import full_fp32, resolve_device
from .marco_corpus import CHUNK, MARCO_D, MARCO_N, MIXTURES, MarcoCorpus

METRIC = "INNER_PRODUCT"
#: the serving draw: 16 x b48 batched rows, then a b1024 batch
N_BATCHES, BATCH, BIG_BATCH = 16, 48, 1024


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=MARCO_N)
    ap.add_argument("--d", type=int, default=MARCO_D)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--mixture", default="skewed", choices=MIXTURES,
                    help="the corpus's mixture (tools/marco_corpus.py): "
                         "skewed (chip_smoke.py's) or balanced (the JAX "
                         "package's tools/marco_graph.py draw)")
    ap.add_argument("--clusters", type=int, default=None,
                    help="mixture centres (default: the mixture's own)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--deg", type=int, default=64)
    ap.add_argument("--inter", type=int, default=64,
                    help="k-NN degree of the build (its carry is 8 bytes a "
                         "row and entry: 4.5 GB at 8.8M x 64)")
    ap.add_argument("--lmax-factor", type=float, default=3.0,
                    help="membership-table capacity factor (the JAX "
                         "package measured 0.753 of the 2n entries kept "
                         "at 1.5 and >= 0.95 at 3.0 over 8.8M rows)")
    ap.add_argument("--half-k", type=int, default=181)
    ap.add_argument("--train-rows", type=int, default=131_072)
    ap.add_argument("--refine-rounds", type=int, default=0)
    ap.add_argument("--descent-sample", type=int, default=4,
                    help="neighbours of each neighbour a descent round "
                         "scores (the JAX tool's 4)")
    ap.add_argument("--serve-codec", default="sq6", choices=["sq8", "sq6"])
    ap.add_argument("--pools", default="16,32,64,128")
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--batches", default="48,1024")
    ap.add_argument("--edge-sample", type=int, default=1024,
                    help="rows whose exact --inter nearest rows measure "
                         "the k-NN graph's edge recall (0: skip)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain torch versions)")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_gib(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))


def serving_queries(corpus: MarcoCorpus) -> np.ndarray:
    """The serving draw: N_BATCHES x BATCH rows, then BIG_BATCH rows."""
    return corpus.queries(BATCH * N_BATCHES + BIG_BATCH)


def batch_queries(xq_all: np.ndarray, b: int) -> np.ndarray:
    """Batch b of the serving draw: b48 its first 48 rows (chip_smoke.py's
    b48), any other b its last b rows (b1024 chip_smoke.py's b1024)."""
    return xq_all[:b] if b == BATCH else xq_all[-b:]


def encode(x: torch.Tensor, vmin, scale, codec: str) -> torch.Tensor:
    """(m, d) fp32 rows → (m, w) packed codes of ``codec`` (ops/sq.py's
    packing)."""
    return sq_pack_t(sq_quantize(x, vmin, scale, SQ_LEVELS[codec]), codec)


def half_centroids(corpus, train_rows: int, half_k: int, n: int):
    """Phase 1: k-means over each half of the dimensions."""
    need = corpus.chunks(min(n, train_rows))
    xt = torch.cat([corpus.chunk(i, m) for i, m in need])[:train_rows]
    dh = xt.shape[1] // 2
    with full_fp32():
        c1, _ = kmeans_fit(xt[:, :dh].contiguous(), half_k, seed=1)
        c2, _ = kmeans_fit(xt[:, dh:].contiguous(), half_k, seed=2)
    return c1, c2


def top2_cells(x: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor
               ) -> torch.Tensor:
    """(m, 2) int64: each row's two nearest product cells (i·half_k + j)
    by the squared L2 distance, the sum of the halves' distances; the
    candidates from each half's top-2 provably hold the top-2 sums."""
    hk, dh = c1.shape[0], c1.shape[1]

    def half_top2(xh, c):
        with full_fp32():
            dist = ((xh * xh).sum(1, keepdim=True) - 2.0 * (xh @ c.T)
                    + (c * c).sum(1)[None, :])
        v, i = exact_topk(-dist, 2)
        return -v, i

    d1, i1 = half_top2(x[:, :dh], c1)
    d2, i2 = half_top2(x[:, dh:], c2)
    cand_d = torch.stack([d1[:, 0] + d2[:, 0], d1[:, 0] + d2[:, 1],
                          d1[:, 1] + d2[:, 0], d1[:, 1] + d2[:, 1]], 1)
    cand_i = torch.stack([i1[:, 0] * hk + i2[:, 0], i1[:, 0] * hk + i2[:, 1],
                          i1[:, 1] * hk + i2[:, 0], i1[:, 1] * hk + i2[:, 1]],
                         1)
    _, sel = exact_topk(-cand_d, 2)
    return cand_i.gather(1, sel)


def build(corpus: MarcoCorpus, n: int, args, dev) -> dict:
    """Phases 1-3: the sq4-coded k-NN graph at ``args.inter`` degree after
    ``args.refine_rounds`` descent rounds.  Returns its pieces and seconds;
    the sq4 buffer is left in ``out["codes4"]`` for the caller to free."""
    out = {"seconds": {}}
    t0 = time.perf_counter()
    c1, c2 = half_centroids(corpus, args.train_rows, args.half_k, n)
    sync(dev)
    out["seconds"]["phase1 product-cell k-means"] = time.perf_counter() - t0
    nlist = args.half_k ** 2

    t0 = time.perf_counter()
    train = corpus.chunk(0, corpus.chunks(n)[0][1])
    vmin4, scale4 = sq_train(train, SQ_LEVELS["sq4"])
    del train
    codes4 = torch.empty((n, (corpus.d + 1) // 2), dtype=torch.uint8,
                         device=dev)
    a12 = np.empty((n, 2), np.int64)
    for i, m in corpus.chunks(n):
        x = corpus.chunk(i, m)
        r0 = i * corpus.chunk_rows
        codes4[r0:r0 + m] = encode(x, vmin4, scale4, "sq4")
        a12[r0:r0 + m] = top2_cells(x, c1, c2).cpu().numpy()
    sync(dev)
    out["seconds"]["phase2 sq4 encode + top-2 cells"] = (time.perf_counter()
                                                         - t0)

    t0 = time.perf_counter()
    table, lmax = graph_ops.membership_table(a12, nlist, args.inter,
                                             lmax_factor=args.lmax_factor)
    out["coverage"] = float((table >= 0).sum() / (2 * n))
    out["lmax"], out["cells"] = lmax, nlist
    log(f"  build cells {nlist}, lmax {lmax}, membership coverage "
        f"{out['coverage']:.4f} of the 2n entries")

    def progress(done, total):
        if done and (done % 8192 == 0 or done == total):
            log(f"  phase3 scan {done}/{total} cells "
                f"({time.perf_counter() - t0:.1f} s)")

    knn = graph_ops.clustered_knn_scan(codes4, table, args.inter, METRIC,
                                       "sq4", vmin4, scale4,
                                       progress=progress)
    del table, a12
    sync(dev)
    out["seconds"]["phase3 coded clustered scan"] = time.perf_counter() - t0
    out["edgeless"] = int((knn < 0).all(1).sum())
    for r in range(args.refine_rounds):
        t0 = time.perf_counter()

        def progress(done, total, r=r):
            if done % 2_097_152 < 262_144 or done == total:
                log(f"  descent round {r + 1}: {done}/{total} rows "
                    f"({time.perf_counter() - t0:.1f} s)")

        knn = graph_ops.nn_descent_round(
            codes4, knn, METRIC, min(args.descent_sample, args.inter),
            "sq4", vmin4, scale4, progress=progress)
        sync(dev)
        out["seconds"][f"phase3 descent round {r + 1}"] = (time.perf_counter()
                                                           - t0)
    out.update(knn=knn, codes4=codes4, vmin4=vmin4, scale4=scale4)
    return out


def exact_neighbours(corpus: MarcoCorpus, n: int, ids: np.ndarray, k: int
                     ) -> np.ndarray:
    """Each row ``ids``'s exact k nearest other rows by inner product: K1
    (ops/flat_topk.py) over each regenerated fp32 chunk at k + 1, merged,
    the row itself dropped.  (len(ids), k) int64."""
    xq = corpus.rows(ids, n)
    best_s = torch.full((len(ids), k + 1), float("-inf"), device=xq.device)
    best_p = torch.full((len(ids), k + 1), -1, dtype=torch.int64,
                        device=xq.device)
    for i, m in corpus.chunks(n):
        s, p = ft.flat_topk(corpus.chunk(i, m), m, xq, k + 1, METRIC)
        best_s, best_p = topk_ordered(
            torch.cat([best_s, s], 1),
            torch.cat([best_p, i * corpus.chunk_rows + p.long()], 1), k + 1)
    pos = best_p.cpu().numpy()
    own = pos == ids[:, None]
    order = np.argsort(own, axis=1, kind="stable")
    return np.take_along_axis(pos, order, 1)[:, :k]


def edge_recall(corpus: MarcoCorpus, n: int, knn: torch.Tensor,
                sample: int, seed: int = 7) -> float:
    """Mean share of a sampled row's exact ``knn.shape[1]`` nearest rows
    that its k-NN graph row holds."""
    ids = np.sort(np.random.default_rng(seed).choice(n, size=min(sample, n),
                                                     replace=False))
    exact = exact_neighbours(corpus, n, ids, knn.shape[1])
    got = knn[torch.from_numpy(ids).to(knn.device)].cpu().numpy()
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist()))
                          / len(b) for a, b in zip(got, exact)]))


def serve_buffer(corpus: MarcoCorpus, n: int, codec: str, dev):
    """Phase 4: the corpus drawn again and encoded in the serve codec:
    (codes (n, w), vmin, scale)."""
    train = corpus.chunk(0, corpus.chunks(n)[0][1])
    vmin, scale = sq_train(train, SQ_LEVELS[codec])
    del train
    w = corpus.d if codec == "sq8" else 3 * ((corpus.d + 3) // 4)
    codes = torch.empty((n, w), dtype=torch.uint8, device=dev)
    for i, m in corpus.chunks(n):
        r0 = i * corpus.chunk_rows
        codes[r0:r0 + m] = encode(corpus.chunk(i, m), vmin, scale, codec)
    return codes, vmin, scale


def walk(codes, graph, xq: np.ndarray, n: int, k: int, pool: int,
         width: int, codec: str, vmin, scale):
    """One coded walk: FAISS-convention (distances, labels) on the card."""
    q = torch.from_numpy(np.ascontiguousarray(xq)).to(codes.device)
    s, p = graph_ops.graph_search(codes, graph, q, n, k, METRIC, pool=pool,
                                  width=width, codec=codec, vmin=vmin,
                                  scale=scale)
    return finalize_scores(s, p, METRIC)


def recall_at(labels: np.ndarray, exact: np.ndarray) -> float:
    k = exact.shape[1]
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist())) / k
                          for a, b in zip(labels, exact)]))


def sweep(codes, graph, n, batches: dict, exact: dict, pools, width, codec,
          vmin, scale, k: int = 10, reps: int = 3) -> dict:
    """Phase 5: each batch at each pool, the best wall of ``reps`` after a
    warm call, recall@k against ``exact``.  {(b, pool): (ms, recall)}."""
    dev = codes.device
    out = {}
    for b, xq in batches.items():
        for pool in pools:
            _, lab = walk(codes, graph, xq, n, k, pool, width, codec, vmin,
                          scale)
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                _, lab = walk(codes, graph, xq, n, k, pool, width, codec,
                              vmin, scale)
                lab = lab.cpu().numpy()
                best = min(best, time.perf_counter() - t0)
            rec = recall_at(lab, exact[b])
            out[b, pool] = (1e3 * best, rec)
            log(f"  walk b{b} ef={pool}: {b / best:9.1f} qps "
                f"({1e3 * best:.1f} ms)  recall@{k} {rec:.4f}")
        sync(dev)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n = args.n
    t_all = time.perf_counter()
    corpus = MarcoCorpus(args.seed, device=dev, d=args.d,
                         centers=args.clusters, chunk_rows=args.chunk,
                         mixture=args.mixture)
    xq_all = serving_queries(corpus)
    batches = {b: batch_queries(xq_all, b)
               for b in (int(v) for v in args.batches.split(","))}
    t0 = time.perf_counter()
    exact = {b: corpus.exact_ip_labels(xq, 10, n) for b, xq in
             batches.items()}
    log(f"corpus {n}x{args.d} unit-norm IP, {args.mixture} mixture of "
        f"{corpus.centers.shape[0]} centres (seed {args.seed}); exact fp32 "
        f"labels of {sum(len(v) for v in batches.values())} queries in "
        f"{time.perf_counter() - t0:.1f} s")

    built = build(corpus, n, args, dev)
    for name, sec in built["seconds"].items():
        log(f"{name}: {sec:.1f} s")
    log(f"k-NN graph: {built['edgeless']} rows without an edge; card memory "
        f"peak {peak_gib(dev):.2f} GiB")
    knn = built.pop("knn")
    if args.edge_sample:
        t0 = time.perf_counter()
        er = edge_recall(corpus, n, knn, args.edge_sample)
        log(f"edge recall of the k-NN graph after {args.refine_rounds} "
            f"descent rounds: {er:.4f} ({args.edge_sample} rows against "
            f"their exact {args.inter} nearest by K1, "
            f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    graph = graph_ops.augment_graph(knn, args.deg)
    del knn
    built.pop("codes4")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sync(dev)
    log(f"phase3 augment_graph to degree {args.deg}: "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    codes, vmin, scale = serve_buffer(corpus, n, args.serve_codec, dev)
    sync(dev)
    log(f"phase4 {args.serve_codec} encode: {time.perf_counter() - t0:.1f} s "
        f"({codes.numel() / 1e9:.2f} GB of codes)")
    pools = [int(p) for p in args.pools.split(",")]
    sweep(codes, graph, n, batches, exact, pools, args.width,
          args.serve_codec, vmin, scale)
    log(f"card memory peak {peak_gib(dev):.2f} GiB; total "
        f"{time.perf_counter() - t_all:.1f} s")
    log("MARCO-GRAPH COMPLETE")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
