"""Chip smoke test of duckdb_faiss_ext_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: a CUDA card must be visible; prints nvidia-smi's name and
   power limit;
2. build: compiles the package's CUDA sources (csrc/*.cu) with nvcc;
3. kernel sweep: the fused distance + top-k kernel (ops/flat_topk.py)
   against its plain torch version on the same card tensors, TF32 off:
   L2 and inner product, nq in {1, 48, 64, 1024}, k in {1, 10, 100, 1024},
   with and without a row mask, nvalid < capacity, d in {8, 128, 1536} at
   1M rows (the 1536-d corpus is 6 GB, generated on the card from a seeded
   generator), plus duplicated rows that must rank by ascending position;
   each case prints its count of margin-unproven queries (the kernel's
   3xTF32 candidates whose (k + m)-th lies within twice the error bound of
   the k-th exact score);
4. golden parity: the reference's test corpus (tests/data) through the
   public API on the card reproduces its 20 golden inner-product distances,
   labels and filtered results;
5. main path: IDMap,Flat L2 over a 1M x 128 clustered corpus (seed 42):
   faiss_create → faiss_add → faiss_search at b48 and b1024 (k=10) →
   faiss_search_batched 16 x b48 → faiss_search_filter('id%2==0') over a
   registered 1M-row table.  Every result is checked against the plain
   version (recall@10 = 1.0, distances within tolerance), the path must
   have launched the kernel and counted no margin-unproven query; then the
   kernel, its plain version and the library yardstick (cuBLAS SGEMM with
   TF32 off + torch.topk, two calls the port never makes) are timed, here
   and at 1M x 1536 inner product (b48 and b1024, no unproven query);
6. IVF sweep: the per-query list search (K6, ops/ivf_list_scan.py: the
   fused search, partial and merge launches, and the raw launch) and the
   pair-tile search (K7, ops/ivf_pairs.py: the fused search, partial and
   merge launches over the 3xTF32 core, and the raw tile launch) against
   their plain versions on the card, raw scores element by element and
   the fused searches' results (K6: scores within 1e-5 of each query's
   scale; K7: within 1e-5 of the batch's largest; positions where apart)
   at k 1 / 10 / 100 / 1024 (K6) and (k, k_scan) (1, 33) / (10, 42) /
   (100, 400) / (256, 1024) (K7) in turn, with equal rows that must rank
   by the lower flat index, and K10's fused search (through TMA and
   through its cp.async instance) bit-equal to K7's: L2 and inner
   product, with and without a mask, nprobe 1 / 3 / 64, d 8 / 128 / 1536,
   lmax 256 and 1024 (counts on both sides of 256, 512 and 768; lists of
   two 512-row shares), lists of count 0 and count == lmax, lists probed
   by up to 256 queries, pair tiles with dead slots and n_tiles < t_max;
   then the pipelined pair tiles (K10, ops/ivf_pairs_mega.py) at the same
   shapes, the raw launch bit-equal to K7's and held against the plain
   version, also with n_tiles cut to 0 and to n_tiles - 3, and the fused
   search bit-equal to K7's and held against the plain version;
7. IVF main path: IDMap,IVF4096,Flat L2 over the same corpus
   (BASELINE.json configs[2]): faiss_manual_train on its first 262,144
   rows → faiss_add of all 1M with ids → faiss_search at nprobe 64 at b48
   and b1024, faiss_search_batched 16 x b48, faiss_search_filter.  Every
   result is held against the plain list scan on the same layout (labels
   equal where distances are separated), the kernel launch counts must
   match the calls (the fused K6 on every call below the pairs rule, the
   fused K7 on every call the rule sends to the pair tiles, the raw
   launches on none), and recall@10 against exact Flat is printed; at
   b48 and b1024 the fused K6 is held against its plain version, timed in
   turns against the raw launch with exact_topk and the resolve (the
   design it replaced), beside its plain version, with its device time a
   launch from torch.profiler and faiss_search's wall time; K6's raw and
   K7's raw scores at b1024 are held against their plain versions, the
   fused K7 is timed against the fused K6, and the top-k of the raw
   score block alone;
8. pair-tile path: IVF1024,Flat inner product over 262,144 x 1536
   (seed 7) at nprobe 16: b1024 goes through the fused K7 by the static
   gate, and through the fused K10 under pairs_impl "mega" with equal
   results, b48 through the fused K6, all held against the plain path;
   the launch counts must show the fused K6, K7 and K10 once each and the
   raw launches never.  The fused K6 at b48 is held against its plain
   version and timed in turns against the raw launch with exact_topk and
   the resolve, beside its bound; the raw K7 and K10 tiles at b1024 are
   held against the plain version and each other; the fused K7 at b1024
   is held against its plain version (K10 bit-equal, through TMA and its
   cp.async instance), its margin-unproven queries counted, the peak card
   memory of the fused call and of the raw launch + epilogue printed, and
   the fused K7 and K10 timed in turns against their raw launch +
   epilogue (the design they replaced), against each other and against
   the fused K6 on the same probes, beside the plain version and the
   bound, with their device time a launch from torch.profiler, and
   faiss_search's wall time at b1024 under both pairs_impl values; the
   same trained index filled again by faiss_add_device of the corpus as a
   card tensor builds a byte-equal layout and equal results;
9. SQ sweep: the int8 IVF,SQ kernels against their plain versions on the
   card, raw scores element by element: the per-query list search (K2,
   ops/ivf_sq_scan.py: its raw launch, and its fused search, whose k_scan
   candidates must equal the plain top-k_scan bit for bit and whose
   results are held against the plain search, at (k, k_scan) (1, 33) /
   (10, 42) / (100, 400) / (256, 1024) in turn, with equal rows that must
   rank by the lower flat index) and the pair tiles (K3,
   ops/ivf_sq_pairs.py) at sq8 / sq4 / sq6, L2 and inner product, with and
   without a mask, d 16 / 33 / 80 / 128 / 1536, lmax 256 and 1024 (K3 also
   2560; counts on both sides of 256, 512 and 768), lists of count 0 and
   count == lmax, tiles
   with dead slots and n_tiles < t_max, K3's tiles bit-equal, also with
   n_tiles cut to 0 and to n_tiles - 3; the spill search (K5,
   ops/sq_spill.py) at sq8 / sq4, nprobe 1 / 16 / 64, a spill sorted by
   list with a list longer than four windows and a query whose probes meet
   inside one window, a ragged last window: the windows bit-equal to their
   plain version, the rescore held against the plain rerank legs;
   then the pipelined pair tiles (K9, ops/ivf_sq_pairs_mega.py) bit-equal
   to their plain version and to K3 at the same codecs, metrics, masks and
   widths, lmax 256 / 1024 / 2560, with n_tiles cut to 0 and to n_tiles -
   3;
10. SQ main path: IVF4096,SQ8 inner product at d = 1536 (the reference's
   MS MARCO ada-002 deployment, tools/marco_scale.py:3-8, README:331), the
   rows cut from 8,841,823 to 2,097,152: a clustered, skewed corpus made on
   the card in 262,144-row chunks, faiss_manual_train on the first chunk,
   faiss_add of every chunk, the padded layout capped at lmax 1024 so the
   longest lists spill; in fast mode at nprobe 16, k=10: faiss_search at
   b48 (the fused K2 + K5) and b1024 (K3 by the static rule + K5),
   faiss_search_batched 16 x b48 and faiss_search_filter('id%2==0').  The
   launch counts must match the calls (K2's raw launch none); every result
   is held against the same path with the plain versions of K2, K3 and K5
   on the same layout; recall@10 against the parity decode path and
   against exact fp32 search is printed; at b48 the fused K2's candidates
   are held bit-equal to the plain top-k_scan and its results against the
   plain search, then it is timed in turns against the raw launch with
   top-k_scan and the torch rerank (the design it replaced), with its
   device time a launch;
   K2's raw scores at the b1024 shapes are held against its plain version,
   K3's and K9's tiles bit-equal to their plain version and to each other,
   all timed, K3 against K9 in turns; the spill search at
   b48 and b1024 checked (K5's windows bit-equal, its rescore against the
   plain legs) and timed stage by stage (windows, window top-k, rescore,
   final top-k) beside the plain windows and legs; faiss_search wall time
   under both pairs_impl values;
11. PQ sweep (after phase 7, while the 1M x 128 corpus is loaded): the
   IVF-PQ / IVF-RQ list search (K8, ops/ivf_pq_scan.py: the query's
   distance table, the table-form scan with its candidates, the merge
   with an exact rescore) against its plain version (the raw score block,
   top-k, resolve), labels equal where the scores are apart and scores
   within 1e-5 of each query's scale, and its table launch against the
   plain table: PQ with dsub 8 (8 bits) and dsub 4 (4 bits), RQ with 2
   stages of 4 bits and 8 of 8, L2 and inner product, with and without a
   mask, d 16 / 128 / 1536 (the 1536-d PQ table with dsub 8 is larger than
   the shared-memory budget), lmax 256 and 1024 (counts on both sides of
   256, 512 and 768), lists of count 0 and count == lmax, duplicated rows,
   nprobe 1 / 16 / 64, k 1 / 10 / 100 / 1024; each case's count of
   margin-unproven queries is printed;
12. IVF-PQ main path: IDMap,IVF4096,PQ16 L2 over the same corpus, 16 bytes
   a vector (examples/compression_pipeline.py:8): faiss_manual_train on its
   first 262,144 rows → faiss_add of all 1M with ids → at nprobe 64
   faiss_search at b48 and b1024, faiss_search_batched 16 x b48,
   faiss_search_filter('id%2==0').  K8's launch count must match the
   calls; every result is held against the same path with K8's plain
   version on the same layout; recall@10 against exact Flat is printed;
   at b48 and b1024 K8 is held against its plain version (and its
   unproven count printed), its peak device memory held below a quarter
   of the (nq, nprobe, lmax) score block the TPU design wrote, then K8,
   its plain version and the library call lists[probe_ids] are timed,
   with faiss_search's wall time and its device stages (coarse top-k,
   table, partial, merge);
13. PQ spill: the same index with its layout capped below its longest
   list, so that the longest lists spill, searched at b48 and held against
   the uncapped index and the gather path (no layout plan);
14. IVF-RQ leg: IVF4096,RQ8x8 L2 over the same corpus (BASELINE.md:80),
   beam-4 encode on the card, b48 and b1024 through K8 held against the
   plain K8 path, then K8 held and timed at b1024 as in phase 12;
15. standalone PQ16 over the same corpus at b48 (ops/pq.py::pq_search on
   card tensors): labels equal to a Flat search (K1) over the decoded
   corpus wherever the distances are separated;
16. MS MARCO device path: IVF4096,SQ8 inner product over the full
   8,841,823 x 1536 rows of the reference's deployment, phase 10's corpus
   made on the card in 262,144-row chunks, faiss_train_device on the first
   chunk, faiss_add_device of every chunk with assign_topk 4 into lists
   padded to 2,560 (capacity-filled, tools/marco_device.py:288-299); in
   fast mode at nprobe 16, k=10: faiss_search at b48 (the fused K2 + K5),
   at b1024 under pairs_impl "grid" (K3 + K5) and "mega" (K9 + K5), equal
   exactly, faiss_search_batched 16 x b48 and faiss_search_filter(
   'id%2==0') under "mega".  The launch counts must match the calls; every
   result is held against the same path with the plain versions of K2,
   K3, K9 and K5; recall@10 against exact fp32 search is printed; K9's raw
   tiles at b1024 are bit-equal to its plain version and K3's, then K9 is
   timed against its plain version and against K3 in turns, the fused K2
   is checked and timed at b48 as in phase 10, the spill search is checked
   and timed stage by stage at b48 and b1024 as in phase 10, and
   faiss_search's wall time and device stages are taken under both
   pairs_impl values.

Each kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over the card's peak rate for their type, computed from the inputs of the
timed call; K1's and the fused K7 / K10's operations run on the TF32
tensor cores, three products a term (495 / 3 TFLOP/s), and K1's fp32 FMA
bound is printed beside.  The fused K6, K2, K7 and K10 write no score
block: their bounds count the distinct probed lists' bytes, the queries,
the probe table and the (nq, k) result (K7 / K10 also the merge's fp32
rescore of k_scan rows a query, at the fp32 rate).  At K2's b48 shapes
its partial launch is also timed alone on CUDA events beside the
profiler's reading.  The last two lines of standard output are a JSON
object describing each kernel (K6's, K2's, K7's and K10's with before_ms,
the time of the design they replaced, taken in turns with them) and the
JSON result line {"ok": true, "device": {...}}.
"""

import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N, D, K = 1_000_000, 128, 10
BATCH, BIG_BATCH, N_BATCHES = 48, 1024, 16
SWEEP_D = (8, 128, 1536)
SWEEP_NQ = (1, 48, 64, 1024)   # 64: b48 as the Flat model launches it
SWEEP_K = (1, 10, 100, 1024)
#: the SQ sweep: widths and list lengths of K2 / K3, widths and spill rows
#: of K5 (its last window ragged)
#: (80: at sq8 whole 16-byte units but half a 32-dimension k-step)
SQ_SWEEP_D, SQ_SWEEP_LMAX = (16, 33, 80, 128, 1536), (256, 1024)
#: the fused K2's (k, k_scan) in turn: k_scan as the index picks it for sq8
#: (max(4 k, k + 32)) up to the fused search's limit of 1024
SQ_SWEEP_K = ((1, 33), (10, 42), (100, 400), (256, 1024))
#: the fused K7 / K10's (k, k_scan) in turn: k_scan as the IVF,Flat index
#: picks it (max(4 k, k + 32)) up to the fused search's limit of 1024
PAIRS_SWEEP_K = SQ_SWEEP_K
SPILL_SWEEP_D, SPILL_SWEEP_ROWS = (33, 1536), 12_800
#: kernel sweep: scores agree to 1e-5 of the query's scale (fp32 sums taken
#: in another order, see compare); main path: distances to 1e-5 of the
#: batch's largest distance.  Positions agree wherever the neighbouring
#: scores are further apart than that.
REL_TOL = 1e-5
KERNEL = {
    "name": "flat_topk",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/flat_topk.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_topk.py:40",
}
IVF_LIST_KERNEL = {
    "name": "ivf_list_scan",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_list_scan.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf.py:63",
}
IVF_PAIRS_KERNEL = {
    "name": "ivf_pairs",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_pairs.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py:748",
}
#: IVF main path (bench.py:231-271, BASELINE.json configs[2]): IVF4096
#: trained on the first 262,144 rows, searched at nprobe 64
IVF_TRAIN, IVF_NPROBE = 262_144, 64
#: pair-tile path at the ada-002 width of the reference's MS MARCO corpus,
#: rows cut from 8.8M
PAIRS_N, PAIRS_D, PAIRS_NLIST, PAIRS_NPROBE = 262_144, 1536, 1024, 16
SQ_LIST_KERNEL = {
    "name": "ivf_sq_scan",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_sq_scan.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf.py:371",
}
SQ_PAIRS_KERNEL = {
    "name": "ivf_sq_pairs",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_sq_pairs.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py:137",
}
SQ_SPILL_KERNEL = {
    "name": "sq_spill",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/sq_spill.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_spill.py:48",
}
#: IVF,SQ main path: the reference's MS MARCO ada-002 deployment
#: (IVF4096,SQ8 inner product, d = 1536; tools/marco_scale.py:3-8), the rows
#: cut from 8,841,823 to fit the time limit; the padded layout capped at
#: lmax 1024 (4096 x 1024 x 1536 B), so the longest lists spill
SQ_N, SQ_D, SQ_NLIST, SQ_NPROBE = 2_097_152, 1536, 4096, 16
SQ_CHUNK, SQ_LMAX_CAP = 262_144, 1024
#: the corpus: unit vectors around 4096 unit centres (noise of norm 0.8),
#: lognormal cluster weights (sigma 0.7) in the training chunk, drifted by a
#: lognormal factor (sigma 0.5) in the later chunks, so that lists differ in
#: length and the longest outgrow the cap (11.5% of the rows spill; the
#: JAX deployment spilled 12% at SQ8, ops/pallas_spill.py:6)
SQ_SIGMA, SQ_DRIFT, SQ_NOISE = 0.7, 0.5, 0.8
PQ_KERNEL = {
    "name": "ivf_pq_scan",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_pq_scan.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf.py:183",
}
#: IVF-PQ main path: the compressed form of the IVF main path's index,
#: IDMap,IVF4096,PQ16, 16 bytes a vector (examples/compression_pipeline.py:8);
#: the IVF-RQ leg: RQ8x8 (BASELINE.md:80)
PQ_FACTORY, RQ_FACTORY = "IDMap,IVF4096,PQ16", "IVF4096,RQ8x8"
#: the K8 sweep: widths, list lengths, and per width the codecs (codec,
#: bytes a row as a function of d, bits a code): PQ with dsub 8 and 4, RQ
#: with 2 and 8 stages
PQ_SWEEP_D, PQ_SWEEP_LMAX = (16, 128, 1536), (256, 1024)
PQ_SWEEP_CODECS = (("pq", lambda d: d // 8, 8), ("pq", lambda d: d // 4, 4),
                   ("rq", lambda d: 2, 4), ("rq", lambda d: 8, 8))
SQ_MEGA_KERNEL = {
    "name": "ivf_sq_pairs_mega",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_sq_pairs_mega.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py:503",
}
FLAT_MEGA_KERNEL = {
    "name": "ivf_pairs_mega",
    "route": "cuda",
    "source": "duckdb_faiss_ext_tpu_torch/csrc/ivf_pairs_mega.cu",
    "replaces": "duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py:655",
}
#: the K9 sweep's list lengths: K3's, and the MS MARCO device layout's
SQ_MEGA_SWEEP_LMAX = (256, 1024, 2560)
#: the MS MARCO device path: the reference's deployment at its full
#: 8,841,823 rows (tools/marco_scale.py:3-8), ingested on the card with
#: capped assignment over each row's 4 nearest lists, lmax capacity-filled
#: as tools/marco_device.py:288-299 sizes it: ceil(1.15·n / (nlist·512))·512
MARCO_N, MARCO_TOPK = 8_841_823, 4
MARCO_LMAX = 512 * -(-int(1.15 * MARCO_N) // (SQ_NLIST * 512))
#: the H100's published peaks (SXM data sheet, dense): device memory,
#: float32 outside the tensor cores, int8, and TF32 on the tensor cores
#: divided by the three products of a 3xTF32 term
HBM_BYTES_S, FP32_OPS_S, INT8_OPS_S = 3.35e12, 67e12, 1979e12
TF32X3_OPS_S = 495e12 / 3

# test/sql/faiss.test:16-38 of the reference: k=2 IP distances per query.
GOLDEN_FLAT_DISTANCES = [
    2.3337207, 2.2165565, 3.5882926, 3.336133, 4.2489142, 4.133893,
    3.3984408, 3.1702023, 2.8143706, 2.7383637, 3.7191334, 3.6072645,
    2.866281, 2.8265002, 4.5306416, 4.3778625, 4.809322, 4.7254314,
    5.233301, 5.0149097,
]
# test/sql/faiss3.test:22-45: (rank 0, rank 1) labels per query.
GOLDEN_LABELS = [
    (374, 59), (374, 676), (768, 880), (374, 623), (374, 623),
    (59, 880), (999, 904), (374, 676), (880, 955), (943, 374),
]
# test/sql/faiss3.test:46-68: faiss_search_filter with column0>100.
GOLDEN_FILTERED = [
    (374, 2.33372), (676, 2.17094), (374, 3.58829), (676, 3.33613),
    (768, 4.24891), (880, 4.13389), (374, 3.39844), (623, 3.1702),
    (374, 2.81437), (623, 2.73836), (880, 3.60726), (374, 3.60568),
    (999, 2.86628), (904, 2.8265), (374, 4.53064), (676, 4.37786),
    (880, 4.80932), (955, 4.72543), (943, 5.2333), (374, 5.01491),
]


#: the card's name and power limit as nvidia-smi reads them, set by
#: phase_environment and named on every log line from then on
CARD = ""


def log(msg):
    print(f"{msg} [{CARD}]" if CARD and CARD not in msg else msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_dataset(n, d, nq, ncl=1024, seed=42):
    """Clustered corpus + queries drawn near its clusters (the JAX
    package's harness.datasets.synthetic_dataset, as bench.py uses it)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 4.0
    xb = (centers[rng.integers(0, ncl, n)]
          + rng.standard_normal((n, d)).astype(np.float32))
    xq = (centers[rng.integers(0, ncl, nq)]
          + rng.standard_normal((nq, d)).astype(np.float32))
    return xb, xq


def compare(scores, pos, ref_scores, ref_pos, xq, batch=False):
    """Max abs score error after checking the kernel's k (score, position)
    pairs against the plain version's, computed one wider so the k-th
    position is checked only when the (k+1)-th score is apart from it;
    raises on disagreement.  Each query's tolerance is REL_TOL times the
    larger of its largest |score| and |q|^2 (the scale of the terms an L2
    score cancels), or with ``batch`` REL_TOL times the batch's largest
    |score|."""
    s, p, rs, rp = (t.cpu().numpy() for t in (scores, pos, ref_scores,
                                                ref_pos))
    k = s.shape[1]
    beyond = rs[:, k:k + 1]
    rs, rp = rs[:, :k], rp[:, :k]
    finite = np.isfinite(rs)
    check(np.array_equal(np.isfinite(s), finite), "missing slots differ")
    check(np.array_equal(p[~finite], rp[~finite]), "missing positions differ")
    if not finite.any():
        return 0.0
    if batch:
        tol = np.full(rs.shape[0], REL_TOL * np.abs(rs[finite]).max())
    else:
        qn = (xq * xq).sum(1).cpu().numpy()
        tol = REL_TOL * np.maximum(np.abs(np.where(finite, rs, 0)).max(1),
                                   qn)
    diff = np.abs(np.where(finite, s - rs, 0))
    check((diff <= tol[:, None]).all(),
          f"score error {diff.max()} above tolerance")
    ext = np.concatenate([rs, beyond], 1) if beyond.size else rs
    far = (np.abs(np.diff(np.where(np.isfinite(ext), ext, -1e30), axis=1))
           > 2 * tol[:, None])
    separated = np.ones_like(finite)
    separated[:, 1:] &= far[:, :k - 1]
    separated[:, :-1] &= far[:, :k - 1]
    if beyond.size:
        separated[:, -1] &= far[:, -1]
    bad = np.argwhere(separated & (p != rp))
    if bad.size:
        q = bad[0, 0]
        log(f"query {q}: kernel {p[q][:12].tolist()} {s[q][:12].tolist()}")
        log(f"query {q}: plain  {rp[q][:12].tolist()} {rs[q][:12].tolist()}")
    check(not bad.size, f"positions differ at {bad[:5].tolist()}")
    return float(diff.max())


def bound(nbytes, ops, ops_rate=FP32_OPS_S):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` through device memory and do ``ops`` at the peak rate
    of their type, whichever is larger."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * ops / ops_rate
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def probed_rows(counts, probe):
    """(lists, rows) of the distinct lists in ``probe``, and the rows summed
    over every (query, probe slot): what a list scan must read once and
    what it must score."""
    c = counts.long()
    distinct = torch.unique(probe.long())
    return (int(distinct.numel()), int(c[distinct].sum()),
            int(c[probe.long()].sum()))


def kernel_entry(spec, launches, err, ms, plain_ms, bound_ms_by,
                 library_ms=None, **extra):
    return dict(spec, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms_by[0],
                bound_by=bound_ms_by[1], library_ms=library_ms, **extra)


def cuda_ms(fn):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def time_pair(kernel_fn, plain_fn, reps=10):
    """Median CUDA-event ms of kernel and plain version, run in turns
    (plain, kernel, kernel, plain, ...) after one warm-up each."""
    kernel_fn()
    plain_fn()
    kt, pt = [], []
    for r in range(reps):
        order = ((plain_fn, pt), (kernel_fn, kt))
        for fn, out in (order if r % 2 == 0 else order[::-1]):
            out.append(cuda_ms(fn))
    return statistics.median(kt), statistics.median(pt)


def phase_environment():
    global CARD
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    CARD = smi
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from duckdb_faiss_ext_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    kernels.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds:.2f} s)")


def phase_sweep():
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.utils.config import next_capacity

    g = torch.Generator(device=DEVICE).manual_seed(1234)
    cap = next_capacity(N)               # the Flat index's bucket for N rows
    before = ft.LAUNCHES
    max_err, n_cases = 0.0, 0
    dups = [10, N // 3, N // 2, N - 1]   # duplicated rows
    for d in SWEEP_D:
        xb = torch.randn(cap, d, device=DEVICE, generator=g)
        # The tie row: a norm of 10·sqrt(d) puts it first for both
        # metrics when it is also the query.
        tie = torch.randn(d, device=DEVICE, generator=g)
        tie *= 10 * d ** 0.5 / tie.norm()
        xb[dups] = tie
        mask = torch.rand(cap, device=DEVICE, generator=g) < 0.5
        mask[dups] = True
        queries = torch.randn(max(SWEEP_NQ), d, device=DEVICE, generator=g)
        queries[:4] = tie
        t0 = time.perf_counter()
        unproven = []
        for metric, nq, k, m in itertools.product(
                ("L2", "INNER_PRODUCT"), SWEEP_NQ, SWEEP_K, (None, mask)):
            xq = queries[:nq].contiguous()
            ft.reset_unproven(DEVICE)
            s, p = ft.flat_topk(xb, N, xq, k, metric, m)
            torch.cuda.synchronize()
            unproven.append(ft.unproven(DEVICE))
            rs, rp = ft.flat_topk_reference(xb, N, xq, k + 1, metric, m)
            max_err = max(max_err, compare(s, p, rs, rp, xq))
            n_cases += 1
            if k >= len(dups):
                ties = p[:min(nq, 4), :len(dups)].cpu().tolist()
                check(ties == [dups] * len(ties), f"tie order {ties}")
        log(f"sweep d={d}: {2 * len(SWEEP_NQ) * len(SWEEP_K) * 2} cases "
            f"agree ({time.perf_counter() - t0:.1f} s); margin-unproven "
            f"queries per case (metric x nq {SWEEP_NQ} x k {SWEEP_K} x mask "
            f"off/on): {unproven}")
        del xb, mask, queries
        torch.cuda.empty_cache()
    check(ft.LAUNCHES - before == n_cases, "a sweep case did not launch")
    log(f"sweep: {n_cases} cases, max abs score error {max_err:.3g}")
    return max_err


def phase_golden():
    import duckdb_faiss_ext_tpu_torch as dt

    def load(name):
        raw = np.loadtxt(os.path.join(HERE, "tests", "data", name),
                         delimiter=",", dtype=np.float64)
        return raw[:, 0].astype(np.int64), raw[:, 1:].astype(np.float32)

    ids, xb = load("training.csv")
    _, xq = load("queries.csv")
    cat = dt.Catalog()
    dt.faiss_create("flat8", 8, "Flat", catalog=cat)
    dt.faiss_add(xb, "flat8", catalog=cat)
    check(catalog_device(cat, "flat8") == DEVICE, "index not on the card")
    res = dt.faiss_search("flat8", 2, xq, catalog=cat)
    err = np.abs(res["distance"].reshape(-1) - GOLDEN_FLAT_DISTANCES)
    np.testing.assert_allclose(res["distance"].reshape(-1),
                               GOLDEN_FLAT_DISTANCES, rtol=2e-6)
    dt.faiss_create("flat82", 8, "IDMap,Flat", catalog=cat)
    dt.faiss_add((ids, xb), "flat82", catalog=cat)
    res = dt.faiss_search("flat82", 2, xq, catalog=cat)
    np.testing.assert_array_equal(res["label"], np.array(GOLDEN_LABELS))
    db = dt.Database()
    db.register("training", {"column0": ids})
    gl, gd = zip(*GOLDEN_FILTERED)
    for fn in (dt.faiss_search_filter, dt.faiss_search_filter_set):
        res = fn("flat82", 2, xq, "column0>100", "column0", "training",
                 catalog=cat, database=db)
        np.testing.assert_array_equal(res["label"].reshape(-1), gl)
        np.testing.assert_allclose(res["distance"].reshape(-1), gd, rtol=1e-4)
    log(f"golden: 20 distances (max rel err "
        f"{float((err / np.abs(GOLDEN_FLAT_DISTANCES)).max()):.3g}), labels "
        f"and filtered results reproduced on the card")
    return float(err.max())


def catalog_device(cat, name):
    index = cat.get(name).index
    return getattr(index, "inner", index).device.type


def main_path_data():
    """The 1M x 128 clustered corpus (seed 42) and its query batches, shared
    by the Flat and IVF main paths."""
    t0 = time.perf_counter()
    xb, xq_all = synthetic_dataset(N, D, nq=BATCH + BIG_BATCH, seed=42)
    data = {"xb": xb, "ids": np.arange(N, dtype=np.int64),
            "b48": xq_all[:BATCH], "b1024": xq_all[BATCH:],
            "batched": xq_all[:BATCH * N_BATCHES]}
    log(f"main path: corpus {N}x{D} generated "
        f"({time.perf_counter() - t0:.1f} s)")
    return data


def phase_main_path(smi, data):
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu_torch.utils.config import (config, next_pow2,
                                                          pad_rows)

    xb, ids = data["xb"], data["ids"]
    xq48, xq1024, xq_batched = data["b48"], data["b1024"], data["batched"]
    db = dt.Database()
    db.register("base", {"id": ids})
    cat = dt.Catalog()

    ft.LAUNCHES = 0
    ft.reset_unproven(DEVICE)
    t0 = time.perf_counter()
    dt.faiss_create("sift", D, "IDMap,Flat", metric_type="L2", catalog=cat)
    dt.faiss_add((ids, xb), "sift", catalog=cat)
    t_add = time.perf_counter() - t0
    out = {
        "b48": dt.faiss_search("sift", K, xq48, catalog=cat),
        "b1024": dt.faiss_search("sift", K, xq1024, catalog=cat),
        "batched": dt.faiss_search_batched("sift", K, xq_batched,
                                           batch_size=BATCH, catalog=cat),
        "filter": dt.faiss_search_filter("sift", K, xq48, "id%2==0", "id",
                                         "base", catalog=cat, database=db),
    }
    launches = ft.LAUNCHES
    expected = 1 + 1 + -(-xq_batched.shape[0] // BATCH) + 1
    check(launches == expected,
          f"main path launched the kernel {launches} times, not {expected}")
    check(catalog_device(cat, "sift") == DEVICE, "index not on the card")
    unproven = ft.unproven(DEVICE)
    check(unproven == 0, f"main path: {unproven} margin-unproven queries")
    log(f"main path: create+add {t_add:.2f} s; {launches} kernel launches; "
        f"0 margin-unproven queries")

    index = cat.get("sift").index.inner
    corpus = index.device_vectors()
    even = torch.from_numpy(ids % 2 == 0).to(DEVICE)
    even = torch.cat([even, torch.zeros(corpus.shape[0] - N, dtype=torch.bool,
                                        device=DEVICE)])
    max_err = 0.0
    for name, xq, m in (("b48", xq48, None), ("b1024", xq1024, None),
                        ("batched", xq_batched, None), ("filter", xq48, even)):
        res = out[name]
        xq_dev = torch.from_numpy(xq).to(DEVICE)
        rd, rp = finalize_scores(*ft.flat_topk_reference(
            corpus, N, xq_dev, K, "L2", m), "L2")
        ref_labels = ids[rp.cpu().numpy()]
        ref_dist = rd.cpu().numpy()
        check(res["label"].shape == (xq.shape[0], K), f"{name}: shape")
        check(np.isfinite(res["distance"]).all(), f"{name}: non-finite")
        recall = np.mean([len(set(a) & set(b)) / K for a, b in
                          zip(res["label"], ref_labels)])
        check(recall == 1.0, f"{name}: recall@10 {recall}")
        tol = REL_TOL * float(np.abs(ref_dist).max())
        err = float(np.abs(res["distance"] - ref_dist).max())
        check(err <= tol, f"{name}: distance error {err} > {tol}")
        if m is not None:
            check((res["label"] % 2 == 0).all(), "filter: odd label returned")
        max_err = max(max_err, err)
        log(f"main path {name}: {xq.shape[0]} queries, recall@10 vs plain "
            f"{recall:.4f}, max distance error {err:.3g}")

    timings = {}
    for name, xq in (("b48", xq48), ("b1024", xq1024)):
        # Timed at the shape the Flat model launches: queries padded to its
        # power-of-two bucket (b48 → 64 rows).
        nq_pad = max(config.min_query_bucket, next_pow2(xq.shape[0]))
        xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(DEVICE)
        ms, plain_ms = time_pair(
            lambda: ft.flat_topk(corpus, N, xq_pad, K, "L2"),
            lambda: ft.flat_topk_reference(corpus, N, xq_pad, K, "L2"))
        lib_ms = library_topk_ms(corpus[:N], xq_pad, K, "L2")
        ft.reset_unproven(DEVICE)
        ft.flat_topk(corpus, N, xq_pad, K, "L2")
        check(ft.unproven(DEVICE) == 0, f"{name}: margin-unproven queries")
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            dt.faiss_search("sift", K, xq, catalog=cat)
            walls.append(1e3 * (time.perf_counter() - t0))
        b, b_fma = k1_bounds(N, D, nq_pad, K)
        timings[name] = (ms, plain_ms, b, lib_ms)
        log(f"time {N}x{D} L2 k={K} {name} ({nq_pad} rows launched): "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{lib_ms:.3f} ms (two calls: cuBLAS SGEMM with TF32 off via "
            f"torch.addmm, then torch.topk) (median CUDA events); bound "
            f"{b[0]:.3f} ms ({b[1]}, 3xTF32 tensor cores), {b_fma[0]:.3f} ms "
            f"({b_fma[1]}, fp32 FMA); faiss_search wall "
            f"{statistics.median(walls):.3f} ms (median) [{smi}]")
    exact = {name: out[name]["label"] for name in ("b48", "b1024")}
    return max_err, launches, timings, exact


def k1_bounds(n, d, nq, k):
    """K1's bound by the 3xTF32 tensor-core rate and by the fp32 FMA rate:
    the corpus and the queries read once, (score, position) written once;
    2·d operations a (query, row) pair."""
    nbytes, ops = 4 * n * d + 4 * nq * d + 8 * nq * k, 2 * nq * n * d
    return bound(nbytes, ops, TF32X3_OPS_S), bound(nbytes, ops)


def library_topk_ms(xb, xq, k, metric):
    """K1's yardstick, two PyTorch calls the port never makes: cuBLAS SGEMM
    with TF32 off (``torch.addmm`` with the rows' norms for L2, which
    ranks as -distance) and ``torch.topk``; median CUDA-event ms."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if metric == "L2":
            bias = -(xb * xb).sum(1)[None, :]
            fn = lambda: torch.topk(  # noqa: E731
                torch.addmm(bias, xq, xb.T, alpha=2.0), k, dim=1)
        else:
            fn = lambda: torch.topk(xq @ xb.T, k, dim=1)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(fn) for _ in range(6))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.empty_cache()
    return ms


def phase_time_1536(smi):
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft

    from duckdb_faiss_ext_tpu_torch.utils.config import next_capacity

    g = torch.Generator(device=DEVICE).manual_seed(99)
    xb = torch.randn(next_capacity(N), 1536, device=DEVICE, generator=g)
    out = {}
    for nq in (BATCH, BIG_BATCH):
        xq = torch.randn(nq, 1536, device=DEVICE, generator=g)
        ms, plain_ms = time_pair(
            lambda: ft.flat_topk(xb, N, xq, K, "INNER_PRODUCT"),
            lambda: ft.flat_topk_reference(xb, N, xq, K, "INNER_PRODUCT"),
            reps=6)
        lib_ms = library_topk_ms(xb[:N], xq, K, "INNER_PRODUCT")
        ft.reset_unproven(DEVICE)
        s, p = ft.flat_topk(xb, N, xq, K, "INNER_PRODUCT")
        unproven = ft.unproven(DEVICE)
        check(unproven == 0, f"1536 b{nq}: {unproven} margin-unproven")
        rs, rp = ft.flat_topk_reference(xb, N, xq, K + 1, "INNER_PRODUCT")
        compare(s, p, rs, rp, xq)
        b, b_fma = k1_bounds(N, 1536, nq, K)
        out[nq] = (ms, plain_ms, lib_ms)
        log(f"time {N}x1536 IP k={K} b{nq}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms (two calls: cuBLAS "
            f"SGEMM with TF32 off, then torch.topk) (median CUDA events); "
            f"bound {b[0]:.3f} ms ({b[1]}, 3xTF32), {b_fma[0]:.3f} ms "
            f"({b_fma[1]}, fp32 FMA); 0 margin-unproven queries [{smi}]")
    return out


def compare_raw(got, want, qn):
    """Raw score blocks (rows, slots) of a kernel and its plain version, on
    the card: -inf slots agree exactly, every other score to REL_TOL of its
    row's scale (the larger of its largest |score| and |q|^2).  Returns
    the max abs error."""
    finite = torch.isfinite(want)
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          "-inf slots differ")
    check(bool(torch.isfinite(got[finite]).all()), "non-finite score")
    if not bool(finite.any()):
        return 0.0
    tol = REL_TOL * torch.maximum(
        torch.where(finite, want.abs(), 0.0).amax(1), qn)
    diff = torch.where(finite, (got - want).abs(), 0.0)
    err = float(diff.max())
    check(bool((diff <= tol[:, None]).all()), f"score error {err} above "
          f"tolerance")
    return err


def k6_raw_error(lists, counts, probe, xq, mask, metric):
    """K6's raw (nq, nprobe, lmax) scores against its plain version on the
    same card tensors."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6

    raw = k6.ivf_list_scan(lists, counts, probe, xq, mask, metric)
    ref = k6.ivf_list_scan_reference(lists, counts, probe, xq, mask, metric)
    nq, nprobe, lmax = raw.shape
    qn = (xq * xq).sum(1)[:, None].expand(nq, nprobe)
    return compare_raw(raw.reshape(-1, lmax), ref.reshape(-1, lmax),
                       qn.reshape(-1))


def live_row_pos(counts, lmax):
    """Storage rows of a padded layout's live slots, list after list; -1
    past each list's count."""
    live = torch.arange(lmax, device=DEVICE)[None, :] < counts[:, None]
    start = torch.cumsum(counts, 0) - counts
    return torch.where(live, start[:, None] + torch.arange(
        lmax, device=DEVICE)[None, :], -1).to(torch.int32)


def k6_topk_error(lists, counts, row_pos, probe, xq, mask, metric, k):
    """The fused K6 search (ivf_list_search on the card) against its plain
    version (``compare``: scores within REL_TOL of each query's scale,
    positions equal where the scores are apart)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops.list_topk import pad_to

    args = (lists, counts, row_pos, probe, xq, mask)
    s, p = pad_to(*k6.ivf_list_search(*args, k=k, metric=metric), k)
    ref = pad_to(*k6.ivf_list_search_reference(*args, k=k + 1,
                                               metric=metric), k + 1)
    return compare(s, p, *ref, xq), (s, p)


def device_ms(fn, reps=10):
    """Device time a launch of each kernel of ``fn`` (torch.profiler) over
    ``reps`` calls, as 'name ms (n of m); ...': the kernel's summed device
    time over the n launches the profiler recorded, divided by n, and m
    the launches made (``reps`` a call).  The profiler can lose launch
    records (9 of 10 recorded at the 8.8M b48 K2 shape): dividing the sum
    by ``reps`` instead read that launch at half its CUDA-event time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return "; ".join(
        f"{kernel_name(e.key)} {e.device_time_total / (e.count * 1e3):.3f} "
        f"ms ({e.count} of {reps})"
        for e in prof.key_averages() if e.device_time_total > 0) or "none"


def kernel_name(key):
    """A profiler event's kernel name without return type, namespace,
    template and parameters."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("<")[0].split("(")[0].split("::")[-1]


def k7_raw_error(lists, counts, xq_t, qs_t, meta, mask, metric):
    """K7's raw (t_max, qg, lmax) tiles against its plain version on the
    same card tensors, over the n_tiles real tiles (the kernel leaves the
    rest unwritten)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    raw = k7.ivf_pairs_scan(lists, counts, xq_t, qs_t, meta, mask, metric)
    ref = k7.ivf_pairs_scan_reference(lists, counts, xq_t, qs_t, meta, mask,
                                      metric)
    n_tiles, lmax = int(meta[0]), raw.shape[2]
    return compare_raw(raw[:n_tiles].reshape(-1, lmax),
                       ref[:n_tiles].reshape(-1, lmax),
                       qs_t[:n_tiles, :, 1].reshape(-1))


def k7_topk_error(lists, counts, row_pos, probe, xq, mask, metric, k,
                  k_scan):
    """The fused pair-tile search through K7, K10 (TMA where it takes the
    widths) and K10's cp.async instance on the same card tensors: K10's
    results bit-equal to K7's, K7's held against the plain version
    (``compare`` with the batch's scale: scores within REL_TOL of the
    batch's largest, positions equal where the scores are apart).
    Returns (max abs error, positions); prints nothing."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops.list_topk import pad_to

    args = (lists, counts, row_pos, probe, xq, mask)
    kw = dict(k=k, k_scan=k_scan, metric=metric)
    s, p = k7.ivf_pairs_search(*args, **kw)
    s10, p10 = k7.ivf_pairs_search(*args, **kw, mega=True)
    check(torch.equal(s10, s) and torch.equal(p10, p), "fused K10 differs "
          "from K7")
    if k7.tma_ok(lists, xq):
        launch = k7.TopKLaunch(*args, **kw, mega=True, tma=False)
        launch.run()
        check(torch.equal(launch.scores, s)
              and torch.equal(launch.positions, p), "fused K10's cp.async "
              "instance differs from K7")
    ref = pad_to(*k7.ivf_pairs_search_reference(*args, k=k + 1,
                                                k_scan=k_scan,
                                                metric=metric), k + 1)
    return compare(s, p, *ref, xq, batch=True), p


def probe_table(g, nq, nlist, nprobe):
    """Distinct random lists per query; query 0 probes list 0 (empty) and
    queries 1 and 2 list 1 (full) first."""
    keys = torch.rand(nq, nlist, device=DEVICE, generator=g)
    keys[0, 0] = keys[1, 1] = keys[2, 1] = -1.0
    return keys.argsort(1)[:, :nprobe].to(torch.int32).contiguous()


def check_tie(p, row_pos, k, metric):
    """Query 2 sits on list 1's rows 4 and 5 (equal rows, both live): under
    L2 they are its two best, tied, and the lower flat index (slot 4) comes
    first."""
    if metric != "L2":
        return
    want = row_pos[1, 4:4 + min(k, 2)]
    check(torch.equal(p[2, :want.numel()], want), f"tie of query 2: "
          f"{p[2, :2].tolist()} not {want.tolist()}")


def phase_ivf_sweep():
    """K6 (the fused search and the raw launch) and K7 (the fused search
    and the raw launch) against their plain versions: L2 / IP, mask off /
    on, nprobe 1 / 3 / 64, d 8 / 128 / 1536, lmax 256 and 1024 (counts on
    both sides of each 256-row chunk edge of the raw K7 and of the fused
    search's 512-row shares), lists of count 0 and count == lmax, K7 with
    dead slots and n_tiles < t_max; the fused K6 at k 1 / 10 / 100 / 1024
    and the fused K7 at (k, k_scan) PAIRS_SWEEP_K in turn, with K10's
    fused search bit-equal to K7's (through TMA and its cp.async
    instance), with equal rows (slots 4 and 5 of every list) that must rank
    by the lower flat index."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10

    g = torch.Generator(device=DEVICE).manual_seed(4321)
    nlist, nq6, nq7 = 64, BATCH, 256
    before = (k6.LAUNCHES, k6.TOPK_LAUNCHES, k7.LAUNCHES, k7.TOPK_LAUNCHES,
              k10.TOPK_LAUNCHES)
    err6 = err6f = err7 = err7f = 0.0
    n_cases = 0
    ks = itertools.cycle(SWEEP_K)
    k_pairs = itertools.cycle(PAIRS_SWEEP_K)
    for d, lmax in itertools.product(SWEEP_D, (256, 1024)):
        t0 = time.perf_counter()
        counts = torch.randint(1, lmax, (nlist,), device=DEVICE, generator=g,
                               dtype=torch.int32)
        counts[0], counts[1] = 0, lmax
        if lmax > 256:
            counts[2:8] = torch.tensor([255, 257, 511, 513, 767, 769])
        lane = torch.arange(lmax, device=DEVICE)
        lists = torch.randn(nlist, lmax, d, device=DEVICE, generator=g)
        lists[:, 5] = lists[:, 4]
        lists *= (lane[None, :] < counts[:, None])[:, :, None]
        row_pos = live_row_pos(counts, lmax)
        mask = (torch.rand(nlist, lmax, device=DEVICE, generator=g)
                < 0.6).to(torch.int8)
        mask[1, 4:6] = 1
        xq = torch.randn(nq7, d, device=DEVICE, generator=g)
        xq[2] = lists[1, 4]
        for metric, m, nprobe in itertools.product(
                ("L2", "INNER_PRODUCT"), (None, mask), (1, 3, 64)):
            probe = probe_table(g, nq7, nlist, nprobe)
            probe6, xq6 = probe[:nq6].contiguous(), xq[:nq6].contiguous()
            err6 = max(err6, k6_raw_error(lists, counts, probe6, xq6, m,
                                          metric))
            k = next(ks)
            e, (_, p) = k6_topk_error(lists, counts, row_pos, probe6, xq6, m,
                                      metric, k)
            check_tie(p, row_pos, k, metric)
            err6f = max(err6f, e)
            xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq, nlist)
            check(int(meta[0]) < xq_t.shape[0], "no padding tiles")
            check(bool(torch.isneginf(qs_t[:int(meta[0]), :, 0]).any())
                  or nprobe * nq7 % k7.QG == 0, "no dead slots")
            err7 = max(err7, k7_raw_error(lists, counts, xq_t, qs_t, meta, m,
                                          metric))
            k, k_scan = next(k_pairs)
            e, p = k7_topk_error(lists, counts, row_pos, probe, xq, m, metric,
                                 k, k_scan)
            check_tie(p, row_pos, k, metric)
            err7f = max(err7f, e)
            n_cases += 1
        log(f"ivf sweep d={d} lmax={lmax}: 12 cases x (K6 fused, K6 raw, "
            f"K7 fused = K10 fused, K7 raw) agree "
            f"({time.perf_counter() - t0:.1f} s)")
        del lists, mask, xq
        torch.cuda.empty_cache()
    check((k6.LAUNCHES - before[0], k6.TOPK_LAUNCHES - before[1],
           k7.LAUNCHES - before[2], k7.TOPK_LAUNCHES - before[3],
           k10.TOPK_LAUNCHES - before[4]) == (n_cases,) * 5,
          "an ivf sweep case did not launch")
    log(f"ivf sweep: {n_cases} cases each, max abs score error K6 fused "
        f"{err6f:.3g}, K6 raw {err6:.3g}, K7 fused {err7f:.3g} (K10 fused "
        f"bit-equal, plan (stages, blocks, TMA) {k10.last_plan}), K7 raw "
        f"{err7:.3g}")
    return max(err6, err6f), max(err7, err7f)


def k10_raw_error(lists, counts, xq_t, qs_t, meta, mask, metric):
    """K10's raw tiles bit-equal to K7's and against its plain version (K7's)
    on the same card tensors, over the real tiles; then with n_tiles cut to
    0 and to a count no tile grouping divides.  Returns the max abs error
    against the plain version."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10

    args = [lists, counts, xq_t, qs_t, meta, mask, metric]
    raw = k10.ivf_pairs_mega_scan(*args)
    n = int(meta[0])
    grid = k7.ivf_pairs_scan(*args)
    check(torch.equal(raw[:n], grid[:n]), "K10 differs from K7")
    ref = k7.ivf_pairs_scan_reference(*args)
    err = compare_raw(raw[:n].reshape(-1, raw.shape[2]),
                      ref[:n].reshape(-1, raw.shape[2]),
                      qs_t[:n, :, 1].reshape(-1))
    for cut in (0, max(0, n - 3)):
        args[4] = meta.clone()
        args[4][0] = cut
        raw = k10.ivf_pairs_mega_scan(*args)
        check(torch.equal(raw[:cut], grid[:cut]), f"K10 at n_tiles {cut}")
    return err


def phase_ivf_mega_sweep():
    """K10 (the raw launch and the fused search) bit-equal to K7 and
    against its plain version: L2 / IP, mask off / on, nprobe 1 / 3 / 64,
    d 8 / 128 / 1536, lmax 256 and 1024 (counts on both sides of each
    256-row chunk edge), lists of count 0 and count == lmax, dead slots,
    n_tiles < t_max, the raw launch at n_tiles 0 and n_tiles - 3, the
    fused search at (k, k_scan) PAIRS_SWEEP_K in turn."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10

    g = torch.Generator(device=DEVICE).manual_seed(4322)
    nlist, nq = 64, 256
    before = (k10.LAUNCHES, k10.TOPK_LAUNCHES)
    err, n_cases = 0.0, 0
    k_pairs = itertools.cycle(PAIRS_SWEEP_K)
    for d, lmax in itertools.product(SWEEP_D, (256, 1024)):
        t0 = time.perf_counter()
        counts = torch.randint(1, lmax, (nlist,), device=DEVICE, generator=g,
                               dtype=torch.int32)
        counts[0], counts[1] = 0, lmax
        if lmax > 256:
            counts[2:8] = torch.tensor([255, 257, 511, 513, 767, 769])
        lane = torch.arange(lmax, device=DEVICE)
        lists = torch.randn(nlist, lmax, d, device=DEVICE, generator=g)
        lists *= (lane[None, :] < counts[:, None])[:, :, None]
        row_pos = live_row_pos(counts, lmax)
        mask = (torch.rand(nlist, lmax, device=DEVICE, generator=g)
                < 0.6).to(torch.int8)
        xq = torch.randn(nq, d, device=DEVICE, generator=g)
        for metric, m, nprobe in itertools.product(
                ("L2", "INNER_PRODUCT"), (None, mask), (1, 3, 64)):
            probe = probe_table(g, nq, nlist, nprobe)
            xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq, nlist)
            check(int(meta[0]) < xq_t.shape[0], "no padding tiles")
            err = max(err, k10_raw_error(lists, counts, xq_t, qs_t, meta, m,
                                         metric))
            k, k_scan = next(k_pairs)
            err = max(err, k7_topk_error(lists, counts, row_pos, probe, xq,
                                         m, metric, k, k_scan)[0])
            n_cases += 1
        log(f"ivf mega sweep d={d} lmax={lmax}: 12 cases, K10 raw and fused "
            f"equal to K7 ({time.perf_counter() - t0:.1f} s)")
        del lists, mask, xq
        torch.cuda.empty_cache()
    check((k10.LAUNCHES - before[0], k10.TOPK_LAUNCHES - before[1])
          == (3 * n_cases, n_cases), "an ivf mega sweep case did not launch")
    log(f"ivf mega sweep: {n_cases} cases, K10 (raw and fused) bit-equal to "
        f"K7, max abs score error against the plain version {err:.3g}; "
        f"fused plan (stages, blocks, TMA) {k10.last_plan}")
    return err


def plain_ivf_search(index, xq, k, nprobe, mask=None):
    """The IVF,Flat search of ``index`` (no IDMap) through the plain list
    scan on the same device layout: the coarse top-nprobe on the batch
    padded as the index pads it, K6's plain version, top-k, positions.
    Returns (distances, storage ids) as numpy."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import (exact_topk,
                                                            finalize_scores)
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.utils.config import (config, next_pow2,
                                                          pad_rows)

    lay = index._build_device_layout()
    nq = xq.shape[0]
    nq_pad = max(config.min_query_bucket, next_pow2(nq))
    xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(DEVICE)
    metric = index.metric.name
    probe = coarse_topk(xq_pad, lay.centroids, nprobe, metric)[:nq]
    raw = k6.ivf_list_scan_reference(lay.payload, lay.counts,
                                     probe.contiguous(), xq_pad[:nq], mask,
                                     metric)
    lmax = lay.payload.shape[1]
    best, sel = exact_topk(raw.reshape(nq, -1), k)
    pos = lay.row_pos[probe.long().gather(1, sel // lmax), sel % lmax]
    dist, pos = finalize_scores(best, pos, metric)
    pos = pos.cpu().numpy()
    return dist.cpu().numpy(), np.where(pos >= 0, index._ids[pos], -1)


def compare_results(name, res, ref_dist, ref_labels, similarity):
    """A public-API result against the plain path, computed one wider so
    the k-th label is checked only where the (k+1)-th distance is apart
    from it: distances within REL_TOL of the batch's largest, labels equal
    wherever the neighbouring distances are further apart than that.
    Returns the max abs error."""
    k = res["label"].shape[1]
    check(ref_labels.shape[1] == k + 1, f"{name}: plain path not one wider")
    finite = np.isfinite(ref_dist[:, :k])
    check(np.array_equal(np.isfinite(res["distance"]), finite),
          f"{name}: missing slots differ")
    tol = REL_TOL * float(np.abs(ref_dist[np.isfinite(ref_dist)]).max())
    err = float(np.abs(np.where(finite, res["distance"], 0)
                       - np.where(finite, ref_dist[:, :k], 0)).max())
    check(err <= tol, f"{name}: distance error {err} > {tol}")
    key = np.where(np.isfinite(ref_dist),
                   -ref_dist if similarity else ref_dist, np.inf)
    gap = np.abs(np.diff(key, axis=1)) > 2 * tol
    sep = finite & gap[:, :k]
    sep[:, 1:] &= gap[:, :k - 1]
    bad = np.argwhere(sep & (res["label"] != ref_labels[:, :k]))
    check(not bad.size, f"{name}: labels differ at {bad[:5].tolist()}")
    return err


def compare_same_k(name, res, ref, similarity):
    """A public-API result against the same path at the same k with the
    plain versions: distances within REL_TOL of the batch's largest, labels
    equal wherever the neighbouring distances are further apart than that
    (the last rank against its left neighbour).  Returns the max abs
    error."""
    rd, rl = ref["distance"], ref["label"]
    finite = np.isfinite(rd)
    check(np.array_equal(np.isfinite(res["distance"]), finite),
          f"{name}: missing slots differ")
    tol = REL_TOL * float(np.abs(rd[finite]).max())
    err = float(np.abs(np.where(finite, res["distance"] - rd, 0)).max())
    check(err <= tol, f"{name}: distance error {err} > {tol}")
    key = np.where(finite, -rd if similarity else rd, np.inf)
    gap = np.abs(np.diff(key, axis=1)) > 2 * tol
    sep = finite.copy()
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    bad = np.argwhere(sep & (res["label"] != rl))
    check(not bad.size, f"{name}: labels differ at {bad[:5].tolist()}")
    return err


def phase_ivf_main(smi, data, exact):
    """IDMap,IVF4096,Flat L2 over the 1M x 128 corpus at nprobe 64, through
    the public API; every result held against the plain path."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.utils.config import pad_rows

    xb, ids = data["xb"], data["ids"]
    db = dt.Database()
    db.register("base", {"id": ids})
    cat = dt.Catalog()
    params = {"nprobe": str(IVF_NPROBE)}
    t0 = time.perf_counter()
    dt.faiss_create("ivf", D, "IDMap,IVF4096,Flat", metric_type="L2",
                    catalog=cat)
    dt.faiss_manual_train(xb[:IVF_TRAIN], "ivf", catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add((ids, xb), "ivf", catalog=cat)
    t_add = time.perf_counter() - t0
    index = cat.get("ivf").index.inner
    t0 = time.perf_counter()
    lay = index._build_device_layout()
    t_layout = time.perf_counter() - t0
    check(index._layout_plan() == ("full", None), "no full layout plan")
    lmax = lay.payload.shape[1]
    log(f"ivf main path: train {t_train:.2f} s, add {t_add:.2f} s, layout "
        f"build+upload {t_layout:.2f} s; lmax {lmax}, longest list "
        f"{int(lay.counts.max())}")

    k6.LAUNCHES = k6.TOPK_LAUNCHES = k7.LAUNCHES = k7.TOPK_LAUNCHES = 0
    out = {
        "b48": dt.faiss_search("ivf", K, data["b48"], params, catalog=cat),
        "b1024": dt.faiss_search("ivf", K, data["b1024"], params,
                                 catalog=cat),
        "batched": dt.faiss_search_batched("ivf", K, data["batched"], params,
                                           batch_size=BATCH, catalog=cat),
        "filter": dt.faiss_search_filter("ivf", K, data["b48"], "id%2==0",
                                         "id", "base", params, catalog=cat,
                                         database=db),
    }
    launches = (k6.TOPK_LAUNCHES, k7.TOPK_LAUNCHES)
    calls = [(64, 1), (BIG_BATCH, 1), (64, N_BATCHES), (64, 1)]
    expected = (sum(n for nq, n in calls if not index.pairs_wanted(nq, lmax)),
                sum(n for nq, n in calls if index.pairs_wanted(nq, lmax)))
    check(launches == expected and k6.LAUNCHES == k7.LAUNCHES == 0,
          f"ivf main path launched (K6 fused, K7 fused) {launches} times, not "
          f"{expected}, and the raw launches (K6, K7) {k6.LAUNCHES}, "
          f"{k7.LAUNCHES} times")
    check(index.device.type == DEVICE, "index not on the card")
    log(f"ivf main path: (K6 fused, K7 fused) launches {launches}")

    even = ((lay.row_pos >= 0) & (lay.row_pos % 2 == 0)).to(torch.int8)
    max_err = 0.0
    for name, xq, m in (("b48", data["b48"], None),
                        ("b1024", data["b1024"], None),
                        ("batched", data["batched"], None),
                        ("filter", data["b48"], even)):
        # The plain path runs each batch as the index ran it (batched:
        # 48 queries at a time), so the coarse top-k sees the same shapes.
        step = BATCH if name == "batched" else xq.shape[0]
        parts = [plain_ivf_search(index, xq[s:s + step], K + 1, IVF_NPROBE,
                                  m)
                 for s in range(0, xq.shape[0], step)]
        ref_d = np.concatenate([p[0] for p in parts])
        ref_l = np.concatenate([p[1] for p in parts])
        res = out[name]
        check(np.isfinite(res["distance"]).all(), f"{name}: non-finite")
        max_err = max(max_err, compare_results(f"ivf {name}", res, ref_d,
                                               ref_l, False))
        if m is not None:
            check((res["label"] % 2 == 0).all(), "filter: odd label")
        recall = (np.mean([len(set(a) & set(b)) / K for a, b in
                           zip(res["label"], exact[name])])
                  if name in exact else float("nan"))
        log(f"ivf main path {name}: {xq.shape[0]} queries agree with the "
            f"plain path (max distance error {max_err:.3g}); recall@10 vs "
            f"exact Flat {recall:.4f}")

    timings = {}
    for name in ("b48", "b1024"):
        xq = data[name]
        nq_pad = 64 if name == "b48" else BIG_BATCH
        xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(DEVICE)
        probe = coarse_topk(xq_pad, lay.centroids, IVF_NPROBE, "L2")
        args = (lay.payload, lay.counts, probe, xq_pad, None, "L2")
        search6 = (lay.payload, lay.counts, lay.row_pos, probe, xq_pad, None)
        err_f, _ = k6_topk_error(*search6, "L2", K)
        max_err = max(max_err, err_f)
        # In turns: the raw launch with exact_topk and the resolve (the
        # design the fused search replaced), the fused search, the fused
        # search, the raw launch.
        ms, before_ms = time_pair(
            lambda: k6.ivf_list_search(*search6, k=K, metric="L2"),
            lambda: k6.ivf_list_search_raw(*search6, k=K, metric="L2"),
            reps=6)
        plain_ms = statistics.median(
            cuda_ms(lambda: k6.ivf_list_search_reference(*search6, k=K,
                                                         metric="L2"))
            for _ in range(3))
        launch = k6.TopKLaunch(*search6, k=K, metric="L2")
        dev_ms = device_ms(launch.run)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            dt.faiss_search("ivf", K, xq, params, catalog=cat)
            walls.append(1e3 * (time.perf_counter() - t0))
        # The distinct probed lists' rows, the queries and the probe table
        # read once, the (nq, k) result written once; 2·d operations a
        # probed row.
        _, rows_once, rows_all = probed_rows(lay.counts, probe)
        b = bound(4 * rows_once * D + 4 * nq_pad * D + 4 * probe.numel()
                  + 8 * nq_pad * K, 2 * D * rows_all)
        timings[name] = (ms, plain_ms, b, before_ms)
        p = launch.plan
        log(f"time IVF4096 {N}x{D} L2 nprobe {IVF_NPROBE} k={K} {name} "
            f"({nq_pad} rows launched; {p['splits']} splits, chunks of "
            f"{p['chunk_rows']} rows, {p['stages']} stages, {p['warps']} "
            f"consumer warps, lanes {launch.lanes}, tma {p['tma']}): K6 fused "
            f"{ms:.3f} ms against the raw launch + exact_topk + resolve "
            f"{before_ms:.3f} ms (in turns), plain {plain_ms:.3f} ms (median "
            f"CUDA events), bound {b[0]:.3f} ms ({b[1]}); agrees with the "
            f"plain version (max abs error {err_f:.3g}); device time a launch "
            f"(torch.profiler): {dev_ms}; faiss_search wall "
            f"{statistics.median(walls):.3f} ms (median) [{smi}]")
        if name == "b1024":
            search = dict(k=K, metric="L2")
            lists = (lay.payload, lay.counts, lay.row_pos, probe, xq_pad, None)
            k7_ms, k6_ms = time_pair(
                lambda: k7.ivf_pairs_search(*lists, k_scan=max(4 * K, K + 32),
                                            **search),
                lambda: k6.ivf_list_search(*lists, **search), reps=6)
            xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq_pad,
                                                      lay.payload.shape[0])
            raw_err6 = k6_raw_error(*args)
            raw_err7 = k7_raw_error(lay.payload, lay.counts, xq_t, qs_t,
                                    meta, None, "L2")
            log(f"ivf main path b1024 raw scores (lmax {lmax}): K6 and K7 "
                f"agree with their plain versions (max abs error K6 "
                f"{raw_err6:.3g}, K7 {raw_err7:.3g})")
            raw = k6.ivf_list_scan(*args).reshape(BIG_BATCH, -1)
            exact_topk(raw, K)
            topk_ms = statistics.median(
                cuda_ms(lambda: exact_topk(raw, K)) for _ in range(6))
            del raw
            log(f"time IVF4096 {N}x{D} L2 nprobe {IVF_NPROBE} b1024: top-k "
                f"of the raw score block alone {topk_ms:.3f} ms (median "
                f"CUDA events) [{smi}]")
            raw7_ms, raw6_ms = time_pair(
                lambda: k7.ivf_pairs_scan(lay.payload, lay.counts, xq_t,
                                          qs_t, meta, None, "L2"),
                lambda: k6.ivf_list_scan(*args), reps=6)
            log(f"time IVF4096 {N}x{D} L2 nprobe {IVF_NPROBE} b1024, K7 "
                f"pair tiles against K6 per query: the fused K7 "
                f"{k7_ms:.3f} vs the fused K6 {k6_ms:.3f} ms, raw scores "
                f"only K7 {raw7_ms:.3f} vs K6's raw launch {raw6_ms:.3f} ms "
                f"(median CUDA events) [{smi}]")
    return max(max_err, raw_err6), raw_err7, launches[0], timings


def clustered_f32(n, d, nq, ncl, seed):
    """Clustered corpus + queries near its clusters, drawn in float32."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d), dtype=np.float32) * 4.0
    xb = centers[rng.integers(0, ncl, n)]
    xb += rng.standard_normal((n, d), dtype=np.float32)
    xq = centers[rng.integers(0, ncl, nq)]
    xq += rng.standard_normal((nq, d), dtype=np.float32)
    return xb, xq


def phase_ivf_pairs(smi):
    """IVF1024,Flat IP over 262,144 x 1536 at nprobe 16: b1024 takes the
    pair tiles (K7) by the static gate, and K10 under pairs_impl "mega",
    b48 the per-query scan (K6); then the same trained index filled on the
    card by faiss_add_device, layout and results equal to faiss_add's."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs_mega as k10
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.utils.config import pad_rows

    t0 = time.perf_counter()
    xb, xq = clustered_f32(PAIRS_N, PAIRS_D, BATCH + BIG_BATCH, PAIRS_NLIST,
                           seed=7)
    cat = dt.Catalog()
    params = {"nprobe": str(PAIRS_NPROBE)}
    dt.faiss_create("marco", PAIRS_D, f"IVF{PAIRS_NLIST},Flat",
                    metric_type="INNER_PRODUCT", catalog=cat)
    dt.faiss_manual_train(xb, "marco", catalog=cat)
    index = cat.get("marco").index
    trained = index.state_dict()
    dt.faiss_add(xb, "marco", catalog=cat)
    lay = index._build_device_layout()
    lmax = lay.payload.shape[1]
    log(f"ivf pairs path: {PAIRS_N}x{PAIRS_D} built in "
        f"{time.perf_counter() - t0:.1f} s; lmax {lmax}")
    check(index.pairs_wanted(BIG_BATCH, lmax), "the gate does not take the "
          "pair tiles at b1024")

    def run_all(name):
        res = {"b1024": dt.faiss_search(name, K, xq[BATCH:], params,
                                        catalog=cat),
               "b48": dt.faiss_search(name, K, xq[:BATCH], params,
                                      catalog=cat)}
        dt.config.pairs_impl = "mega"
        try:
            res["b1024-mega"] = dt.faiss_search(name, K, xq[BATCH:], params,
                                                catalog=cat)
        finally:
            dt.config.pairs_impl = "grid"
        return res

    k6.LAUNCHES = k6.TOPK_LAUNCHES = k7.LAUNCHES = k7.TOPK_LAUNCHES = 0
    k10.LAUNCHES = k10.TOPK_LAUNCHES = 0
    out = run_all("marco")
    launches = (k6.TOPK_LAUNCHES, k7.TOPK_LAUNCHES, k10.TOPK_LAUNCHES)
    raw_launches = (k6.LAUNCHES, k7.LAUNCHES, k10.LAUNCHES)
    check(launches == (1, 1, 1) and raw_launches == (0, 0, 0), f"pairs path "
          f"launched (K6, K7, K10 fused) {launches}, the raw launches (K6, "
          f"K7, K10) {raw_launches}")
    check(index._last_scan_path == "pairs-mega-flat", "mega not taken")
    for key in ("label", "distance"):
        check(np.array_equal(out["b1024-mega"][key], out["b1024"][key]),
              f"mega and grid b1024 {key}s differ")
    max_err = 0.0
    for name, q in (("b1024", xq[BATCH:]), ("b48", xq[:BATCH])):
        ref_d, ref_l = plain_ivf_search(index, q, K + 1, PAIRS_NPROBE)
        max_err = max(max_err, compare_results(
            f"pairs {name}", out[name], ref_d, ref_l, True))
    log(f"ivf pairs path: b1024 through the fused K7 and K10 (equal; the raw "
        f"launches 0 times) and b48 through the fused K6 agree with the "
        f"plain path (max distance error {max_err:.3g})")
    xq48 = torch.from_numpy(pad_rows(xq[:BATCH], 64)).to(DEVICE)
    probe48 = coarse_topk(xq48, lay.centroids, PAIRS_NPROBE, "INNER_PRODUCT")
    search48 = (lay.payload, lay.counts, lay.row_pos, probe48, xq48, None)
    err48, _ = k6_topk_error(*search48, "INNER_PRODUCT", K)
    ms48, before48 = time_pair(
        lambda: k6.ivf_list_search(*search48, k=K, metric="INNER_PRODUCT"),
        lambda: k6.ivf_list_search_raw(*search48, k=K,
                                       metric="INNER_PRODUCT"), reps=6)
    dev48 = device_ms(k6.TopKLaunch(*search48, k=K,
                                    metric="INNER_PRODUCT").run)
    # K6's bound (as phase 7's): the distinct probed lists' rows, the
    # queries and the probe table read once, the result written once; 2·d
    # fp32 operations a probed row.
    _, once48, all48 = probed_rows(lay.counts, probe48)
    b48 = bound(4 * once48 * PAIRS_D + 4 * 64 * PAIRS_D + 4 * probe48.numel()
                + 8 * 64 * K, 2 * PAIRS_D * all48)
    max_err = max(max_err, err48)
    log(f"time IVF{PAIRS_NLIST} {PAIRS_N}x{PAIRS_D} IP nprobe {PAIRS_NPROBE} "
        f"b48 (64 rows launched): K6 fused {ms48:.3f} ms against the raw "
        f"launch + exact_topk + resolve {before48:.3f} ms (in turns, median "
        f"CUDA events), bound {b48[0]:.3f} ms ({b48[1]}; {once48} distinct "
        f"rows, {all48} scored); agrees with the plain version (max abs "
        f"error {err48:.3g}); device time a launch (torch.profiler): {dev48} "
        f"[{smi}]")

    xq_dev = torch.from_numpy(xq[BATCH:]).to(DEVICE)
    probe = coarse_topk(xq_dev, lay.centroids, PAIRS_NPROBE, "INNER_PRODUCT")
    xq_t, qs_t, meta, _ = k7.pair_tile_inputs(probe, xq_dev, PAIRS_NLIST)
    args = (lay.payload, lay.counts, xq_t, qs_t, meta, None, "INNER_PRODUCT")
    raw_err = k7_raw_error(*args)
    raw_err10 = k10_raw_error(*args)
    raw_bytes = 4 * xq_t.shape[0] * qs_t.shape[1] * lmax
    log(f"ivf pairs path b1024 raw tiles ({int(meta[0])} of {xq_t.shape[0]} "
        f"tiles, lmax {lmax}): the raw K7 agrees with its plain version (max "
        f"abs error {raw_err:.3g}); the raw K10 bit-equal to it (max abs "
        f"error against the plain version {raw_err10:.3g})")
    del xq_t, qs_t, meta, args
    k_scan = max(4 * K, K + 32)
    lists = (lay.payload, lay.counts, lay.row_pos, probe, xq_dev, None)
    kw = dict(k=K, k_scan=k_scan, metric="INNER_PRODUCT")
    err7, _ = k7_topk_error(*lists, "INNER_PRODUCT", K, k_scan)
    k7.reset_unproven(DEVICE)
    k7.ivf_pairs_search(*lists, **kw)
    unproven = k7.unproven(DEVICE)

    def peak_bytes(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        del res
        return torch.cuda.max_memory_allocated() - base

    peak7 = peak_bytes(lambda: k7.ivf_pairs_search(*lists, **kw))
    peak10 = peak_bytes(lambda: k7.ivf_pairs_search(*lists, **kw, mega=True))
    peak_raw = peak_bytes(lambda: k7.ivf_pairs_search_raw(*lists, **kw))
    check(max(peak7, peak10) < raw_bytes, "the fused search took as much "
          "card memory as the raw tile block")
    launch7 = k7.TopKLaunch(*lists, **kw)
    launch10 = k7.TopKLaunch(*lists, **kw, mega=True)
    p7 = launch7.plan
    log(f"ivf pairs path b1024 fused search (k={K}, k_scan {k_scan}; "
        f"{int(launch7.tables[1][1, -1])} items of up to {p7['tiles']} tiles "
        f"x {p7['share_rows']} rows, at most {p7['items']}; K7 {p7['stages']} "
        f"stages; K10 {launch10.plan['stages']} stages, TMA "
        f"{launch10.plan['tma']}): agrees with the plain version (max abs "
        f"error {err7:.3g}), K10 bit-equal to K7 (TMA and cp.async); "
        f"{unproven} margin-unproven queries of {BIG_BATCH}; peak card "
        f"memory of the call: K7 fused {peak7 / 2**20:.1f} MiB, K10 fused "
        f"{peak10 / 2**20:.1f} MiB, the raw launch + epilogue "
        f"{peak_raw / 2**20:.1f} MiB (its raw block alone "
        f"{raw_bytes / 2**20:.1f} MiB) [{smi}]")
    ms, before_ms = time_pair(
        lambda: k7.ivf_pairs_search(*lists, **kw),
        lambda: k7.ivf_pairs_search_raw(*lists, **kw), reps=6)
    ms10, before10 = time_pair(
        lambda: k7.ivf_pairs_search(*lists, **kw, mega=True),
        lambda: k7.ivf_pairs_search_raw(*lists, **kw, mega=True), reps=6)
    ms10b, ms7b = time_pair(
        lambda: k7.ivf_pairs_search(*lists, **kw, mega=True),
        lambda: k7.ivf_pairs_search(*lists, **kw), reps=6)
    plain_ms = statistics.median(
        cuda_ms(lambda: k7.ivf_pairs_search_reference(*lists, **kw))
        for _ in range(3))
    k7_ms, k6_ms = time_pair(
        lambda: k7.ivf_pairs_search(*lists, **kw),
        lambda: k6.ivf_list_search(*lists, k=K, metric="INNER_PRODUCT"),
        reps=6)
    dev7, dev10 = device_ms(launch7.run), device_ms(launch10.run)
    # The distinct probed lists' rows, the queries and the probe table read
    # once, the (nq, k) result written once; 3xTF32 takes 3 tensor-core
    # products of 2·d operations a scored (query, row) pair, and the merge
    # rescores k_scan rows a query in fp32 (counted at the fp32 rate).
    _, rows_once, rows_all = probed_rows(lay.counts, probe)
    b = bound(4 * rows_once * PAIRS_D + 4 * BIG_BATCH * PAIRS_D
              + 4 * probe.numel() + 8 * BIG_BATCH * K,
              2 * PAIRS_D * rows_all + 2 * PAIRS_D * k_scan * BIG_BATCH
              * TF32X3_OPS_S / FP32_OPS_S, TF32X3_OPS_S)
    log(f"time IVF{PAIRS_NLIST} {PAIRS_N}x{PAIRS_D} IP nprobe {PAIRS_NPROBE} "
        f"b1024 k={K} (median CUDA events, in turns): the fused K7 {ms:.3f} "
        f"ms against the raw K7 + epilogue {before_ms:.3f} ms; the fused K10 "
        f"{ms10:.3f} ms against the raw K10 + epilogue {before10:.3f} ms; "
        f"the fused K10 {ms10b:.3f} against the fused K7 {ms7b:.3f} ms; the "
        f"fused K7 {k7_ms:.3f} against the fused K6 {k6_ms:.3f} ms; plain "
        f"{plain_ms:.3f} ms; bound {b[0]:.3f} ms ({b[1]}; {rows_once} "
        f"distinct rows, {rows_all} scored); device time a launch "
        f"(torch.profiler): K7 {dev7}; K10 {dev10} [{smi}]")
    walls = {"grid": [], "mega": []}
    for r in range(10):
        for impl in (("grid", "mega") if r % 2 == 0 else ("mega", "grid")):
            dt.config.pairs_impl = impl
            try:
                t0 = time.perf_counter()
                dt.faiss_search("marco", K, xq[BATCH:], params, catalog=cat)
                walls[impl].append(1e3 * (time.perf_counter() - t0))
            finally:
                dt.config.pairs_impl = "grid"
    log(f"time IVF{PAIRS_NLIST} {PAIRS_N}x{PAIRS_D} IP nprobe {PAIRS_NPROBE} "
        f"b1024 k={K}: faiss_search wall "
        f"{statistics.median(walls['grid']):.3f} ms under pairs_impl grid "
        f"(K7), {statistics.median(walls['mega']):.3f} ms under mega (K10) "
        f"(median of 10, in turns) [{smi}]")

    # The same trained index filled on the card: faiss_add_device of the
    # corpus as a card tensor, at the host layout's lmax.
    dt.faiss_create("marco_dev", PAIRS_D, f"IVF{PAIRS_NLIST},Flat",
                    metric_type="INNER_PRODUCT", catalog=cat)
    dev_index = cat.get("marco_dev").index
    dev_index.load_state(trained)
    xb_dev = torch.from_numpy(xb).to(DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dt.faiss_add_device(xb_dev, "marco_dev", lmax=lmax, catalog=cat)
    dev_lay = dev_index._build_device_layout()
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    del xb_dev
    for name in ("payload", "counts", "row_pos", "centroids"):
        check(torch.equal(getattr(dev_lay, name), getattr(lay, name)),
              f"device-built {name} differs from the host-built one")
    check(dev_index._spill is None and index._spill is None, "a spill")
    dev_out = run_all("marco_dev")
    for name, res in dev_out.items():
        for key in ("label", "distance"):
            check(np.array_equal(res[key], out[name][key]),
                  f"device-ingested {name} {key}s differ")
    log(f"ivf pairs path: faiss_add_device of the {PAIRS_N}x{PAIRS_D} card "
        f"tensor + layout {t_dev:.2f} s; layout byte-equal to faiss_add's, "
        f"b1024 (K7 and K10) and b48 results equal [{smi}]")
    del dev_lay, dev_out
    dt.faiss_destroy("marco_dev", catalog=cat)
    return ((max(max_err, raw_err, err7), launches[1], (ms, plain_ms, b),
             before_ms),
            (max(raw_err10, err7), launches[2], (ms10, plain_ms, b),
             before10))

def sq_rows(g, n, d, codec):
    """n random packed SQ rows, their rn / rs, ranges and a row mask."""
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_code_width, sq_unpack

    codes = torch.randint(0, 256, (n, sq_code_width(d, codec)),
                          device=DEVICE, generator=g, dtype=torch.uint8)
    scale = torch.rand(d, device=DEVICE, generator=g) / 40 + 1e-3
    vmin = torch.randn(d, device=DEVICE, generator=g)
    c = sq_unpack(codes, codec)[:, :d].to(torch.float32)
    mask = (torch.rand(n, device=DEVICE, generator=g) < 0.6).to(torch.int8)
    return codes, ((c * scale) ** 2).sum(1), c.sum(1), vmin, scale, mask


def sq_sweep_layout(g, nlist, lmax, d, codec):
    """Random SQ codes padded per list (one list empty, one full, counts on
    both sides of 256 / 512 / 768 at lmax 1024, slot 5 of every list equal
    to slot 4), their rn / rs, ranges and a mask (list 1's slots 4 and 5
    live)."""
    codes, rn, rs, vmin, scale, mask = sq_rows(g, nlist * lmax, d, codec)
    counts = torch.randint(1, lmax, (nlist,), device=DEVICE, generator=g,
                           dtype=torch.int32)
    counts[0], counts[1] = 0, lmax
    if lmax > 256:
        counts[2:8] = torch.tensor([255, 257, 511, 513, 767, 769])
    live = (torch.arange(lmax, device=DEVICE)[None, :] < counts[:, None])
    codes, rn, rs, mask = (t.reshape(nlist, lmax, -1) for t in (codes, rn, rs,
                                                               mask))
    for t in (codes, rn, rs):
        t[:, 5] = t[:, 4]
    mask[1, 4:6] = 1
    codes = codes * live[:, :, None].to(torch.uint8)
    return (codes, counts, rn[:, :, 0] * live, rs[:, :, 0] * live, vmin,
            scale, mask[:, :, 0].contiguous())


def k2_topk_error(codes, rn, rs, counts, row_pos, probe, xq, mask, vmin,
                  scale, metric, codec, k, k_scan):
    """The fused K2 search on the card against its plain version: the
    k_scan candidates its merge writes bit-equal to the plain exact_topk of
    the raw int8 scores (scores, and flat indices where the score is
    finite), then its results (``compare`` one wider: distances within
    REL_TOL of the batch's largest, positions where they are apart).
    Returns (max abs error, (scores, positions))."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.list_topk import pad_to
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    args = (codes, rn, rs, counts, row_pos, probe, xq, mask, vmin, scale)
    kw = dict(k_scan=k_scan, metric=metric, codec=codec)
    s, p = pad_to(*k2.ivf_sq_list_search(*args, k=k, **kw), k)
    launch = k2.TopKLaunch(*args, k=k, **kw)
    launch.run()
    cs, cp = launch.candidates
    q = query_digits(xq, vmin, scale, metric, codec, codes.shape[2],
                     KERNEL_SHIFT[codec])
    raw = k2.ivf_sq_scan_reference(codes, rn, rs, counts, probe, q.digits,
                                   q.scalars, mask, metric, codec)
    bs, sel = exact_topk(raw.reshape(xq.shape[0], -1), launch.plan["k2"])
    check(torch.equal(cs, bs), "K2 candidate scores differ from the plain "
          "top-k_scan")
    fin = torch.isfinite(bs)
    check(torch.equal(cp[fin].long(), sel[fin]) and bool((cp[~fin] == -1)
                                                         .all()),
          "K2 candidates differ from the plain top-k_scan")
    check(torch.equal(launch.scores, s) and torch.equal(launch.positions, p),
          "K2 differs between two runs")
    ref = pad_to(*k2.ivf_sq_list_search_reference(*args, k=k + 1, **kw),
                 k + 1)
    return compare(s, p, *ref, xq, batch=True), (s, p)


def k2_raw_error(codes, rn, rs, counts, probe, q, mask, metric, codec):
    """K2's raw (nq, nprobe, lmax) scores against its plain version on the
    same card tensors; the row scale counts the query's |base|."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2

    args = (codes, rn, rs, counts, probe, q.digits, q.scalars, mask, metric,
            codec)
    raw = k2.ivf_sq_scan(*args)
    ref = k2.ivf_sq_scan_reference(*args)
    lmax, nprobe = raw.shape[2], raw.shape[1]
    return compare_raw(raw.reshape(-1, lmax), ref.reshape(-1, lmax),
                       q.scalars[:, 2].abs().repeat_interleave(nprobe))


def k3_raw_error(codes, rn, rs, counts, tiles, mask, metric, codec):
    """K3's raw tiles bit-equal to its plain version's (torch.equal: -0.0
    equals +0.0) over the real tiles, then with n_tiles cut to 0 and to a
    count no tile grouping divides.  Returns the max abs error (0 when
    bit-equal)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3

    digits_t, scalars_t, meta, _ = tiles
    args = [codes, rn, rs, counts, digits_t, scalars_t, meta, mask, metric,
            codec]
    n = int(meta[0])
    ref = k3.ivf_sq_pairs_scan_reference(*args)
    check(torch.equal(k3.ivf_sq_pairs_scan(*args)[:n], ref[:n]),
          "K3 differs from its plain version")
    for cut in (0, max(0, n - 3)):
        args[6] = meta.clone()
        args[6][0] = cut
        check(torch.equal(k3.ivf_sq_pairs_scan(*args)[:cut], ref[:cut]),
              f"K3 at n_tiles {cut}")
    return 0.0


def k5_raw_error(args):
    """K5's (window max, first argmax) bit-equal to its plain version
    (torch.equal: -0.0 equals +0.0)."""
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5

    wmax, warg = k5.sq_spill_windows(*args)
    rmax, rarg = k5.sq_spill_windows_reference(*args)
    check(torch.equal(wmax, rmax), "window maxima differ")
    check(torch.equal(warg, rarg), "window argmax differs")
    return 0.0


def rescore_inputs(wmax, k):
    """The windows an sq8 spill search selects for k: (bestw, wsel,
    kw)."""
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk

    nwin = wmax.shape[1]
    k = min(k, nwin)
    k_scan = min(nwin, max(4 * k, k + 32))
    bestw, wsel = exact_topk(wmax, k_scan)
    return bestw, wsel, min(nwin, k + 2)


def rescore_error(codes, assign, pos, mask, n_rows, probe, xq, vmin, scale,
                  wmax, warg, metric, codec, k=K):
    """K5's rescore against ``spill_rescore_reference`` on the same card
    tensors: -inf in the same places, every other score within REL_TOL of
    the largest.  Returns (max abs error, the plain version's scores)."""
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5

    bestw, wsel, kw = rescore_inputs(wmax, k)
    args = (codes, assign, pos, mask, n_rows, probe, xq, vmin, scale, bestw,
            wsel, warg, kw, metric, codec)
    got = k5.spill_rescore(*args)
    want = k5.spill_rescore_reference(*args)
    finite = torch.isfinite(want)
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          "rescore: -inf slots differ")
    if not bool(finite.any()):
        return 0.0, want
    tol = REL_TOL * float(want[finite].abs().max())
    err = float((got[finite] - want[finite]).abs().max())
    check(err <= tol, f"rescore error {err} above {tol}")
    return err, want


def spill_probe_table(g, nq, nlist, nprobe):
    """``probe_table`` where, with two probes or more, query 2 probes lists
    5 and 6, whose spill rows meet inside a window."""
    keys = torch.rand(nq, nlist, device=DEVICE, generator=g)
    keys[0, 0] = keys[1, 1] = -1.0
    if nprobe > 1:
        keys[2, 5] = keys[2, 6] = -1.0
    return keys.argsort(1)[:, :nprobe].to(torch.int32).contiguous()


def phase_sq_sweep():
    """K2 (the raw launch and the fused search) and K3 against their plain
    versions: sq8 / sq4 / sq6, L2 / IP, mask off / on, d 16 / 33 / 80 /
    128 / 1536, lmax 256 and 1024 (K3 also 2560, bit-equal, and with
    n_tiles cut to 0 and n_tiles - 3), nprobe in turn 1 / 3 / 16 / 64; the
    fused K2's k_scan candidates bit-equal to the plain top-k_scan and its
    results held against the plain search at (k, k_scan) in turn
    SQ_SWEEP_K, with equal rows (slots 4 and 5) that must rank by the lower
    flat index; K5 at sq8 / sq4, nprobe 1 / 16 / 64, d 33 / 1536, a ragged
    last window and a partial query group."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5
    from duckdb_faiss_ext_tpu_torch.ops.ivf_pairs import QG
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_decode
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    g = torch.Generator(device=DEVICE).manual_seed(2468)
    nlist, nq2, nq3 = 64, BATCH, 256
    before = (k2.LAUNCHES, k2.TOPK_LAUNCHES, k3.LAUNCHES, k5.LAUNCHES)
    err2 = err2f = err3 = err5 = 0.0
    n2 = n3 = n5 = 0
    nprobes = itertools.cycle((1, 3, 16, 64))
    k_pairs = itertools.cycle(SQ_SWEEP_K)
    for d, lmax in itertools.product(SQ_SWEEP_D, SQ_MEGA_SWEEP_LMAX):
        t0 = time.perf_counter()
        xq0 = torch.randn(nq3, d, device=DEVICE, generator=g)
        for codec in ("sq8", "sq4", "sq6"):
            codes, counts, rn, rs, vmin, scale, mask = sq_sweep_layout(
                g, nlist, lmax, d, codec)
            w = codes.shape[2]
            row_pos = live_row_pos(counts, lmax)
            # query 2 sits on list 1's equal rows 4 and 5
            xq = xq0.clone()
            xq[2] = sq_decode(codes[1, 4:5], vmin, scale, codec)[0]
            for metric, m in itertools.product(("L2", "INNER_PRODUCT"),
                                               (None, mask)):
                probe = probe_table(g, nq3, nlist, next(nprobes))
                q = query_digits(xq, vmin, scale, metric, codec, w,
                                 KERNEL_SHIFT[codec])
                if lmax in SQ_SWEEP_LMAX:
                    q2 = type(q)(q.digits[:nq2].contiguous(),
                                 q.scalars[:nq2].contiguous())
                    probe2 = probe[:nq2].contiguous()
                    err2 = max(err2, k2_raw_error(
                        codes, rn, rs, counts, probe2, q2, m, metric, codec))
                    k, k_scan = next(k_pairs)
                    e, (_, p) = k2_topk_error(
                        codes, rn, rs, counts, row_pos, probe2,
                        xq[:nq2].contiguous(), m, vmin, scale, metric, codec,
                        k, k_scan)
                    check_tie(p, row_pos, k, metric)
                    err2f = max(err2f, e)
                    n2 += 1
                tiles = k3.sq_pair_tile_inputs(probe, q, nlist, metric)
                n_tiles = int(tiles[2][0])
                check(n_tiles < tiles[1].shape[0], "no padding tiles")
                check(bool(torch.isinf(tiles[1][:n_tiles, :, 2]).any())
                      or probe.numel() % QG == 0, "no dead slots")
                err3 = max(err3, k3_raw_error(codes, rn, rs, counts, tiles,
                                              m, metric, codec))
                n3 += 1
            del codes, rn, rs, mask
        k2_note = ("K2 raw agrees, K2 fused candidates bit-equal and results "
                   "agree, " if lmax in SQ_SWEEP_LMAX else "")
        log(f"sq sweep d={d} lmax={lmax}: 12 cases, {k2_note}K3 bit-equal "
            f"({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    from duckdb_faiss_ext_tpu_torch.ops.sq_spill import spill_offsets

    nq5, s_pad, n_rows = 250, SPILL_SWEEP_ROWS, SPILL_SWEEP_ROWS - 53
    rescore_before = k5.RESCORE_LAUNCHES
    for d, codec in itertools.product(SPILL_SWEEP_D, ("sq8", "sq4")):
        t0 = time.perf_counter()
        codes, rn, rs, vmin, scale, mask = sq_rows(g, s_pad, d, codec)
        w = codes.shape[1]
        # Sorted by list as the layouts keep a spill; list 5 holds about
        # 1,100 rows (over eight windows), list 7 none.
        weights = torch.ones(nlist, device=DEVICE)
        weights[5], weights[7] = 6.0, 0.0
        assign = torch.multinomial(weights, s_pad, replacement=True,
                                   generator=g).sort().values.to(torch.int32)
        offsets = torch.from_numpy(spill_offsets(
            assign[:n_rows].cpu().numpy(), nlist)).to(DEVICE)
        check(int(offsets[6] - offsets[5]) > 4 * k5.WIN, "no long list")
        check(int(offsets[6]) % k5.WIN != 0, "lists 5 and 6 meet on a "
              "window edge")
        pos = torch.where(torch.rand(s_pad, device=DEVICE, generator=g)
                          < 0.95, torch.arange(s_pad, device=DEVICE),
                          -1).to(torch.int32)
        xq = torch.randn(nq5, d, device=DEVICE, generator=g)
        for metric, m, nprobe in itertools.product(
                ("L2", "INNER_PRODUCT"), (None, mask), (1, 16, 64)):
            q = query_digits(xq, vmin, scale, metric, codec, w,
                             KERNEL_SHIFT[codec])
            probe = spill_probe_table(g, nq5, nlist, nprobe)
            args = (codes, assign, pos, rs, rn, m, probe, q.digits,
                    q.scalars, n_rows, metric, codec, offsets)
            k5_raw_error(args)
            wmax, warg = k5.sq_spill_windows(*args)
            err, _ = rescore_error(codes, assign, pos, m, n_rows, probe, xq,
                                   vmin, scale, wmax, warg, metric, codec)
            err5 = max(err5, err)
            n5 += 1
        log(f"sq sweep K5 d={d} {codec}: 12 cases, windows bit-equal, "
            f"rescore agrees ({time.perf_counter() - t0:.1f} s)")
        del codes
        torch.cuda.empty_cache()
    check(k5.RESCORE_LAUNCHES - rescore_before == n5,
          "an sq sweep rescore did not launch")
    check((k2.LAUNCHES - before[0], k2.TOPK_LAUNCHES - before[1],
           k3.LAUNCHES - before[2], k5.LAUNCHES - before[3])
          == (n2, n2, 3 * n3, 2 * n5), "an sq sweep case did not launch")
    log(f"sq sweep: {n2} cases for K2 (raw, and fused: candidates bit-equal), "
        f"{n3} for K3 (bit-equal; K3 blocks an SM at the last "
        f"{k3.last_blocks}), {n5} for K5 (windows bit-equal); max abs score "
        f"error K2 raw {err2:.3g}, K2 fused {err2f:.3g}, K3 {err3:.3g}, K5 "
        f"rescore {err5:.3g}")
    return max(err2, err2f), err3, err5


def k9_raw_error(codes, rn, rs, counts, tiles, mask, metric, codec):
    """K9's raw tiles bit-equal to its plain version's and to K3's on the
    same card tensors, over the real tiles; then with n_tiles cut to 0 and
    to a count no tile grouping divides.  Returns the max abs error (0 when
    bit-equal)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9

    digits_t, scalars_t, meta, _ = tiles
    args = [codes, rn, rs, counts, digits_t, scalars_t, meta, mask, metric,
            codec]
    raw = k9.ivf_sq_pairs_mega_scan(*args)
    n = int(meta[0])
    ref = k3.ivf_sq_pairs_scan_reference(*args)
    check(torch.equal(raw[:n], ref[:n]), "K9 differs from its plain version")
    check(torch.equal(raw[:n], k3.ivf_sq_pairs_scan(*args)[:n]),
          "K9 differs from K3")
    for cut in (0, max(0, n - 3)):
        args[6] = meta.clone()
        args[6][0] = cut
        check(torch.equal(k9.ivf_sq_pairs_mega_scan(*args)[:cut], ref[:cut]),
              f"K9 at n_tiles {cut}")
    return 0.0


def phase_sq_mega_sweep():
    """K9 bit-equal to its plain version and to K3: sq8 / sq4 / sq6, L2 /
    IP, mask off / on, d 16 / 33 / 80 / 128 / 1536, lmax 256 / 1024 / 2560
    (counts on both sides of 256, 512 and 768, count 0 and count == lmax),
    nprobe in turn 1 / 3 / 16 / 64, dead slots, n_tiles < t_max, n_tiles 0
    and n_tiles - 3."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    g = torch.Generator(device=DEVICE).manual_seed(2469)
    nlist, nq = 64, 256
    before = k9.LAUNCHES
    err, n_cases = 0.0, 0
    nprobes = itertools.cycle((1, 3, 16, 64))
    for d, lmax in itertools.product(SQ_SWEEP_D, SQ_MEGA_SWEEP_LMAX):
        t0 = time.perf_counter()
        xq = torch.randn(nq, d, device=DEVICE, generator=g)
        for codec in ("sq8", "sq4", "sq6"):
            codes, counts, rn, rs, vmin, scale, mask = sq_sweep_layout(
                g, nlist, lmax, d, codec)
            w = codes.shape[2]
            for metric, m in itertools.product(("L2", "INNER_PRODUCT"),
                                               (None, mask)):
                probe = probe_table(g, nq, nlist, next(nprobes))
                q = query_digits(xq, vmin, scale, metric, codec, w,
                                 KERNEL_SHIFT[codec])
                tiles = k3.sq_pair_tile_inputs(probe, q, nlist, metric)
                check(int(tiles[2][0]) < tiles[1].shape[0], "no padding tiles")
                err = max(err, k9_raw_error(codes, rn, rs, counts, tiles, m,
                                            metric, codec))
                n_cases += 1
            del codes, rn, rs, mask
        log(f"sq mega sweep d={d} lmax={lmax}: 12 cases, K9 bit-equal to its "
            f"plain version and K3 ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    check(k9.LAUNCHES - before == 3 * n_cases,
          "an sq mega sweep case did not launch")
    log(f"sq mega sweep: {n_cases} cases bit-equal; last plan (stages, "
        f"blocks, TMA) {k9.last_plan}")
    return err


class MarcoCorpus:
    """The SQ main path's corpus, made on the card chunk by chunk from
    seeded generators, so any chunk can be made again for exact search."""

    def __init__(self, seed=11):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        self.seed = seed
        self.centers = torch.nn.functional.normalize(
            torch.randn(SQ_NLIST, SQ_D, device=DEVICE, generator=g), dim=1)
        logw = torch.randn(SQ_NLIST, device=DEVICE, generator=g) * SQ_SIGMA
        drift = torch.randn(SQ_NLIST, device=DEVICE, generator=g) * SQ_DRIFT
        self.w_train = torch.softmax(logw, 0)
        self.w_rest = torch.softmax(logw + drift, 0)

    def _draw(self, n, weights, stream):
        g = torch.Generator(device=DEVICE).manual_seed(
            self.seed * 1000 + stream)
        c = torch.multinomial(weights, n, replacement=True, generator=g)
        x = self.centers[c] + torch.randn(
            n, SQ_D, device=DEVICE, generator=g) * (SQ_NOISE / SQ_D ** 0.5)
        return torch.nn.functional.normalize(x, dim=1)

    def chunk(self, i, n=SQ_CHUNK):
        """Rows [i·SQ_CHUNK, i·SQ_CHUNK + n) on the card."""
        return self._draw(n, self.w_train if i == 0 else self.w_rest, i + 1)

    def queries(self, n):
        return self._draw(n, self.w_rest, 999).cpu().numpy()


@contextlib.contextmanager
def plain_sq_kernels():
    """Run the IVF,SQ path with the plain versions of K2 (the fused search),
    K3, K9 and K5 (windows and rescore) in place of their wrappers (same
    signatures, same inputs)."""
    from duckdb_faiss_ext_tpu_torch.models import ivf_serve
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5

    saved = (ivf_serve.ivf_sq_list_search, k3.ivf_sq_pairs_scan,
             k9.ivf_sq_pairs_mega_scan, k5.sq_spill_windows, k5.spill_rescore)
    ivf_serve.ivf_sq_list_search = k2.ivf_sq_list_search_reference
    k3.ivf_sq_pairs_scan = k3.ivf_sq_pairs_scan_reference
    k9.ivf_sq_pairs_mega_scan = k3.ivf_sq_pairs_scan_reference
    k5.sq_spill_windows = k5.sq_spill_windows_reference
    k5.spill_rescore = k5.spill_rescore_reference
    try:
        yield
    finally:
        (ivf_serve.ivf_sq_list_search, k3.ivf_sq_pairs_scan,
         k9.ivf_sq_pairs_mega_scan, k5.sq_spill_windows,
         k5.spill_rescore) = saved


def time_k2(tag, lay, xq, probe, vmin, scale, k_scan, metric, codec, smi):
    """The fused K2 at one batch of a main path: its candidates bit-equal
    to the plain top-k_scan and its results held against the plain search
    (``k2_topk_error``), then timed in turns against the raw launch with
    top-k_scan and the torch rerank (the design it replaced), beside its
    plain version, with its device time a launch.  Returns (ms, plain ms,
    bound, before ms), the max abs error."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import list_topk as lt
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    args = (lay.payload, lay.rn, lay.rs, lay.counts, lay.row_pos, probe, xq,
            None, vmin, scale)
    kw = dict(k=K, k_scan=k_scan, metric=metric, codec=codec)
    err, _ = k2_topk_error(*args, metric, codec, K, k_scan)
    ms, before_ms = time_pair(lambda: k2.ivf_sq_list_search(*args, **kw),
                              lambda: k2.ivf_sq_list_search_raw(*args, **kw),
                              reps=6)
    plain_ms = statistics.median(
        cuda_ms(lambda: k2.ivf_sq_list_search_reference(*args, **kw))
        for _ in range(3))
    launch = k2.TopKLaunch(*args, **kw)
    dev = device_ms(launch.run)
    # The partial launch alone on CUDA events, 20 back to back, beside the
    # profiler's reading: two clocks for the time the bound is held to.
    launch.run()
    part_ms = cuda_ms(lambda: [launch.run(lt.PARTIAL)
                               for _ in range(20)]) / 20
    w = lay.payload.shape[2]
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    _, once, pairs = probed_rows(lay.counts, probe)
    _, once_real, _ = probed_rows(lay.counts, probe[:BATCH])
    b = sq_bound(q, probe, 8 * xq.shape[0] * K, once * (w + 8), pairs)
    log(f"{tag}: K2's partial alone {part_ms:.3f} ms a launch (CUDA events, "
        f"20 back to back); rows it must read: {once} distinct of {pairs} "
        f"scored ({once_real} distinct for the {BATCH} real queries), "
        f"{once * (w + 8) / 1e9:.3f} GB, {once * (w + 8) / part_ms / 1e9:.3f}"
        f" TB/s at that time")
    p = launch.plan
    log(f"time {tag} k={K} k_scan={k_scan} ({xq.shape[0]} rows launched; "
        f"{p['splits']} splits, chunks of {p['chunk_rows']} rows, "
        f"{p['stages']} stages, {p['warps']} consumer warps, tma "
        f"{p['tma']}): K2 fused {ms:.3f} ms against the "
        f"raw launch + top-k_scan + torch rerank {before_ms:.3f} ms (in "
        f"turns), plain {plain_ms:.3f} ms (median CUDA events), bound "
        f"{b[0]:.3f} ms ({b[1]}); candidates bit-equal to the plain "
        f"top-k_scan, results agree (max abs error {err:.3g}); device time a "
        f"launch (torch.profiler): {dev} [{smi}]")
    return (ms, plain_ms, b, before_ms), err


def exact_ip_labels(corpus, xq, k, n_rows=SQ_N):
    """Exact fp32 inner-product top-k over the corpus's first ``n_rows``,
    made again on the card chunk by chunk."""
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import (exact_topk,
                                                            topk_ordered)
    from duckdb_faiss_ext_tpu_torch.utils.config import full_fp32

    q = torch.from_numpy(xq).to(DEVICE)
    best_s = torch.full((q.shape[0], k), float("-inf"), device=DEVICE)
    best_p = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                        device=DEVICE)
    for i, n in corpus_chunks(n_rows):
        with full_fp32():
            s, p = exact_topk(q @ corpus.chunk(i, n).T, k)
        best_s, best_p = topk_ordered(torch.cat([best_s, s], 1),
                                      torch.cat([best_p, i * SQ_CHUNK + p],
                                                1), k)
    return best_p.cpu().numpy()


def corpus_chunks(n_rows):
    """(chunk index, rows) of the corpus's first ``n_rows``."""
    return [(i, min(SQ_CHUNK, n_rows - i * SQ_CHUNK))
            for i in range(-(-n_rows // SQ_CHUNK))]


def sq_bound(q, probe, out_bytes, rows_bytes, pairs):
    """An int8 SQ scan's bound: the distinct probed lists' codes with their
    rn / rs (``rows_bytes``), the queries' digits and scalars read once,
    the raw scores written once (``out_bytes``: K2 every slot, K3 / K9 the
    real tiles, K5 a (max, argmax) per real window); 2 int8 operations a
    digit of every scored (query, row) pair."""
    dig = q.digits[0].numel()
    return bound(rows_bytes + q.digits.numel() + 4 * q.scalars.numel()
                 + 4 * probe.numel() + out_bytes, 2 * dig * pairs, INT8_OPS_S)


def recall(labels, ref):
    return float(np.mean([len(set(a) & set(b)) / len(a)
                          for a, b in zip(labels, ref)]))


def spill_report(tag, spill, vmin, scale, xq, probe, metric, codec, smi):
    """The spill search of one batch on the card: K5's windows bit-equal to
    the plain version and its rescore held against the plain legs, then
    the stages timed (windows, window top-k, rescore, final top-k) beside
    the plain windows and legs.  Returns (K5 ms: windows + rescore, plain
    ms: plain windows + plain legs, bound, rescore error)."""
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)

    w = spill.payload.shape[1]
    q = query_digits(xq, vmin, scale, metric, codec, w, KERNEL_SHIFT[codec])
    wargs = (spill.payload, spill.assign, spill.pos, spill.rs, spill.rn,
             None, probe, q.digits, q.scalars, spill.n, metric, codec,
             spill.offsets)
    k5_raw_error(wargs)
    wmax, warg = k5.sq_spill_windows(*wargs)
    err, plain_s2 = rescore_error(
        spill.payload, spill.assign, spill.pos, None, spill.n, probe, xq,
        vmin, scale, wmax, warg, metric, codec)
    bestw, wsel, kw = rescore_inputs(wmax, K)
    rargs = (spill.payload, spill.assign, spill.pos, None, spill.n, probe, xq,
             vmin, scale, bestw, wsel, warg, kw, metric, codec)
    s2 = k5.spill_rescore(*rargs)
    stages = {
        "windows (K5)": lambda: k5.sq_spill_windows(*wargs),
        "window top-k": lambda: exact_topk(wmax, wsel.shape[1]),
        "rescore (K5)": lambda: k5.spill_rescore(*rargs),
        "final top-k": lambda: exact_topk(s2, K),
        "whole spill search": lambda: k5.sq_spill_search(
            spill.payload, spill.assign, spill.pos, spill.rs, spill.rn,
            spill.n, probe, xq, None, vmin, scale, k=K, metric=metric,
            codec=codec, offsets=spill.offsets),
        "plain windows": lambda: k5.sq_spill_windows_reference(*wargs),
        "plain legs": lambda: k5.spill_rescore_reference(*rargs),
    }
    ms = {}
    for label, fn in stages.items():
        fn()
        ms[label] = statistics.median(cuda_ms(fn) for _ in range(5))
    k5_ms = ms["windows (K5)"] + ms["rescore (K5)"]
    plain_ms = ms["plain windows"] + ms["plain legs"]
    # Bytes: the probed lists' spill rows (codes, pos, rs, rn) and the
    # queries' digits, scalars and probes read once, the windows' (max,
    # argmax) written once; the distinct valid rescored rows' codes, the
    # queries and the window selection read once, the score block written
    # once.  Operations: 2 int8 a digit of every scored (query, row) pair;
    # 4·d fp32 (decode and dot) a valid rescored pair, 6·d for L2.
    nq, nwin = wmax.shape
    sp_counts = torch.bincount(spill.assign[:spill.n].long(),
                               minlength=int(spill.offsets.numel()) - 1)
    once = int(sp_counts[torch.unique(probe.long())].sum())
    pairs = int(sp_counts[probe.long()].sum())
    lane = torch.arange(k5.WIN, device=DEVICE)
    cand = torch.cat([(wsel[:, :kw, None] * k5.WIN + lane).reshape(nq, -1),
                      warg.gather(1, wsel[:, kw:]).long()], 1)
    live = torch.isfinite(plain_s2)
    rows = int(torch.unique(cand[live]).numel())
    d = xq.shape[1]
    nbytes = (once * (w + 12) + q.digits.numel() + 4 * q.scalars.numel()
              + 4 * probe.numel() + 8 * nq * nwin + rows * w + 4 * nq * d
              + 8 * wsel.numel() + 4 * plain_s2.numel())
    by_bytes = 1e3 * nbytes / HBM_BYTES_S
    by_ops = 1e3 * (2 * q.digits[0].numel() * pairs / INT8_OPS_S
                    + (6 if metric == "L2" else 4) * d * int(live.sum())
                    / FP32_OPS_S)
    b = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    log(f"time {tag} spill search {nq} rows launched ({spill.n} spill rows, "
        f"{once} in probed lists, {pairs} (query, row) pairs, {rows} rows "
        f"rescored): windows bit-equal, rescore max abs error {err:.3g}; "
        f"stages (median CUDA events) "
        + "; ".join(f"{label} {v:.3f} ms" for label, v in ms.items())
        + f"; K5 (windows + rescore) {k5_ms:.3f} ms against the plain "
        f"windows + legs {plain_ms:.3f} ms; bound {b[0]:.3f} ms ({b[1]}) "
        f"[{smi}]")
    return k5_ms, plain_ms, b, err


def phase_sq_main(smi):
    """IVF4096,SQ8 IP over 2,097,152 x 1536 at nprobe 16 through the public
    API, in fast mode (the int8 path)."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import exact_topk
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.ops.ivf_sq_pairs import (
        ivf_sq_pairs_search)
    from duckdb_faiss_ext_tpu_torch.ops.ivf_sq_scan import ivf_sq_list_search
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)
    from duckdb_faiss_ext_tpu_torch.ops.sq_spill import sq_spill_search
    from duckdb_faiss_ext_tpu_torch.utils.config import pad_rows

    metric, codec = "INNER_PRODUCT", "sq8"
    corpus = MarcoCorpus()
    xq_all = corpus.queries(BATCH * N_BATCHES + BIG_BATCH)
    data = {"b48": xq_all[:BATCH], "b1024": xq_all[-BIG_BATCH:],
            "batched": xq_all[:BATCH * N_BATCHES]}
    ids = np.arange(SQ_N, dtype=np.int64)
    db = dt.Database()
    db.register("passages", {"id": ids})
    cat = dt.Catalog()
    params = {"nprobe": str(SQ_NPROBE)}
    t0 = time.perf_counter()
    dt.faiss_create("marco", SQ_D, f"IVF{SQ_NLIST},SQ8", metric_type=metric,
                    catalog=cat)
    index = cat.get("marco").index
    index.LAYOUT_BUDGET_BYTES = SQ_NLIST * SQ_LMAX_CAP * SQ_D
    dt.faiss_manual_train(corpus.chunk(0).cpu().numpy(), "marco",
                          catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(SQ_N // SQ_CHUNK):
        dt.faiss_add(corpus.chunk(i).cpu().numpy(), "marco", catalog=cat)
    t_add = time.perf_counter() - t0
    dt.set_precision("fast")
    counts = index._counts()
    n_spill = int(np.maximum(counts - SQ_LMAX_CAP, 0).sum())
    log(f"sq main path: train {t_train:.2f} s, add {t_add:.2f} s; codes "
        f"{index._codes.nbytes / 1e9:.2f} GB; lists: mean "
        f"{SQ_N / SQ_NLIST:.0f}, median {int(np.median(counts))}, longest "
        f"{int(counts.max())}, {int((counts > SQ_LMAX_CAP).sum())} over "
        f"{SQ_LMAX_CAP}; spill {n_spill} rows ({100 * n_spill / SQ_N:.2f}% "
        f"of {SQ_N})")
    check(0.01 * SQ_N <= n_spill <= index.SPILL_FRACTION_MAX * SQ_N,
          "spill outside 1-20% of the rows")
    check(index._layout_plan() == ("spill", SQ_LMAX_CAP), "no capped plan")
    t0 = time.perf_counter()
    lay = index._build_device_layout()
    log(f"sq main path: layout build+upload {time.perf_counter() - t0:.2f} s")
    spill = index._spill
    lmax = lay.payload.shape[1]
    check(spill.n == n_spill and lmax == SQ_LMAX_CAP, "layout differs")

    def run_all():
        return {
            "b48": dt.faiss_search("marco", K, data["b48"], params,
                                   catalog=cat),
            "b1024": dt.faiss_search("marco", K, data["b1024"], params,
                                     catalog=cat),
            "batched": dt.faiss_search_batched("marco", K, data["batched"],
                                               params, batch_size=BATCH,
                                               catalog=cat),
            "filter": dt.faiss_search_filter("marco", K, data["b48"],
                                             "id%2==0", "id", "passages",
                                             params, catalog=cat,
                                             database=db),
        }

    k2.LAUNCHES = k2.TOPK_LAUNCHES = k3.LAUNCHES = k5.LAUNCHES = 0
    k5.RESCORE_LAUNCHES = 0
    out = run_all()
    launches = (k2.TOPK_LAUNCHES, k3.LAUNCHES, k5.LAUNCHES)
    check(k5.RESCORE_LAUNCHES == k5.LAUNCHES, "a spill search missed the "
          "rescore kernel")
    calls = [(64, 1), (BIG_BATCH, 1), (64, N_BATCHES), (64, 1)]
    expected = (sum(n for nq, n in calls if not index.pairs_wanted(nq, lmax)),
                sum(n for nq, n in calls if index.pairs_wanted(nq, lmax)),
                sum(n for _, n in calls))
    check(launches == expected and k2.LAUNCHES == 0, f"sq main path "
          f"launched (K2 fused, K3, K5) {launches} times, not {expected}, "
          f"and K2's raw launch {k2.LAUNCHES} times")
    check(expected[1] == 1, "b1024 does not take the pair tiles")
    check(index.device.type == DEVICE, "index not on the card")
    log(f"sq main path: (K2 fused, K3, K5) launches {launches}")

    t0 = time.perf_counter()
    with plain_sq_kernels():
        ref = run_all()
    check((k2.TOPK_LAUNCHES, k3.LAUNCHES, k5.LAUNCHES) == launches
          and k2.LAUNCHES == 0 and k5.RESCORE_LAUNCHES == launches[2],
          "the plain path launched a kernel")
    log(f"sq main path: plain path ({time.perf_counter() - t0:.1f} s)")
    max_err = 0.0
    for name, res in out.items():
        check(res["label"].shape == (data["b48" if name == "filter"
                                          else name].shape[0], K),
              f"{name}: shape")
        check(np.isfinite(res["distance"]).all(), f"{name}: non-finite")
        max_err = max(max_err, compare_same_k(f"sq {name}", res, ref[name],
                                              True))
        if name == "filter":
            check((res["label"] % 2 == 0).all(), "filter: odd label")
    log(f"sq main path: b48, b1024, batched and filter agree with the plain "
        f"path (max distance error {max_err:.3g})")

    dt.set_precision("parity")
    t0 = time.perf_counter()
    decode = dt.faiss_search("marco", K, data["b48"], params, catalog=cat)
    t_decode = time.perf_counter() - t0
    check(index._last_scan_path == "gather", "parity did not decode")
    dt.set_precision("fast")
    exact = {name: exact_ip_labels(corpus, data[name], K)
             for name in ("b48", "b1024")}
    r_dec = recall(out["b48"]["label"], decode["label"])
    r48 = recall(out["b48"]["label"], exact["b48"])
    r1024 = recall(out["b1024"]["label"], exact["b1024"])
    log(f"sq main path: recall@10 vs the parity decode path (b48, "
        f"{1e3 * t_decode:.0f} ms with its layout build) {r_dec:.4f}; vs "
        f"exact fp32 search: b48 {r48:.4f}, b1024 {r1024:.4f}")

    vmin, scale = index._sq_ranges()
    shapes = {}
    for name, nq_pad in (("b48", 64), ("b1024", BIG_BATCH)):
        xq = torch.from_numpy(pad_rows(data[name], nq_pad)).to(DEVICE)
        probe = coarse_topk(xq, lay.centroids, SQ_NPROBE, metric)
        q = query_digits(xq, vmin, scale, metric, codec, lay.payload.shape[2],
                         KERNEL_SHIFT[codec])
        shapes[name] = (xq, probe, q)
    xq, probe, q = shapes["b1024"]
    tiles = k3.sq_pair_tile_inputs(probe, q, SQ_NLIST, metric)
    lists = (lay.payload, lay.rn, lay.rs, lay.counts)
    raw2 = k2_raw_error(*lists, probe, q, None, metric, codec)
    raw3 = max(k3_raw_error(*lists, tiles, None, metric, codec),
               k9_raw_error(*lists, tiles, None, metric, codec))
    log(f"sq main path b1024 raw scores (lmax {lmax}, {int(tiles[2][0])} of "
        f"{tiles[1].shape[0]} tiles): K2 agrees with its plain version (max "
        f"abs error {raw2:.3g}); K3 and K9 tiles bit-equal to the plain "
        f"version and to each other")

    timings = {}
    xq48, probe48, q48 = shapes["b48"]
    k_scan48 = index._sq_kscan(K, SQ_NPROBE * lmax)
    timings["k2"], err2f = time_k2(
        f"IVF{SQ_NLIST},SQ8 {SQ_N}x{SQ_D} IP nprobe {SQ_NPROBE} b48", lay,
        xq48, probe48, vmin, scale, k_scan48, metric, codec, smi)
    raw2 = max(raw2, err2f)
    a3 = (*lists, *tiles[:3], None, metric, codec)
    timings["k3"] = time_pair(lambda: k3.ivf_sq_pairs_scan(*a3),
                              lambda: k3.ivf_sq_pairs_scan_reference(*a3),
                              reps=4)
    ms9, ms3 = time_pair(lambda: k9.ivf_sq_pairs_mega_scan(*a3),
                         lambda: k3.ivf_sq_pairs_scan(*a3), reps=10)
    k5_48 = spill_report(f"IVF{SQ_NLIST},SQ8 {SQ_N}x{SQ_D} IP b48", spill,
                         vmin, scale, shapes["b48"][0], shapes["b48"][1],
                         metric, codec, smi)
    k5_1024 = spill_report(f"IVF{SQ_NLIST},SQ8 {SQ_N}x{SQ_D} IP b1024", spill,
                           vmin, scale, xq, probe, metric, codec, smi)
    timings["k5"] = k5_1024[:3]
    raw5 = max(k5_48[3], k5_1024[3])
    w = lay.payload.shape[2]
    _, once, rows_all = probed_rows(lay.counts, probe)
    n_tiles = int(tiles[2][0])
    timings["k3"] += (sq_bound(q, probe, 4 * n_tiles * tiles[1].shape[1]
                               * lmax, once * (w + 8), rows_all),)
    a21024 = (*lists, probe, q.digits, q.scalars, None, metric, codec)
    k2_1024 = statistics.median(
        cuda_ms(lambda: k2.ivf_sq_scan(*a21024)) for _ in range(6))
    pv = k3.ivf_sq_pairs_scan(*a3).reshape(-1, lmax)[
        tiles[3].reshape(-1).long()].reshape(BIG_BATCH, -1)
    k_scan = index._sq_kscan(K, SQ_NPROBE * lmax)
    exact_topk(pv, k_scan)
    topk_ms = statistics.median(
        cuda_ms(lambda: exact_topk(pv, k_scan)) for _ in range(6))
    del pv
    log(f"time IVF{SQ_NLIST},SQ8 {SQ_N}x{SQ_D} IP nprobe {SQ_NPROBE} raw "
        f"scores (median CUDA events): K2 fused b48 (64 rows) "
        f"{timings['k2'][0]:.3f} ms, plain {timings['k2'][1]:.3f} ms; K2's "
        f"raw launch b1024 {k2_1024:.3f} ms; "
        f"K3 b1024 {timings['k3'][0]:.3f} ms, plain {timings['k3'][1]:.3f} "
        f"ms; in turns K9 {ms9:.3f} ms against K3 {ms3:.3f} ms (K3 "
        f"{k3.last_blocks} blocks an SM, K9 plan {k9.last_plan}); K5 (windows + rescore) b1024 {timings['k5'][0]:.3f} ms, plain "
        f"{timings['k5'][1]:.3f} ms; K5 b48 {k5_48[0]:.3f} ms, plain "
        f"{k5_48[1]:.3f} ms; top-{k_scan} of the b1024 pair-gathered block "
        f"{topk_ms:.3f} ms; bounds K2 b48 {timings['k2'][2][0]:.3f} ms "
        f"({timings['k2'][2][1]}), K3 b1024 {timings['k3'][2][0]:.3f} ms "
        f"({timings['k3'][2][1]}), K5 b1024 {timings['k5'][2][0]:.3f} ms "
        f"({timings['k5'][2][1]}) [{smi}]")
    for name in ("b48", "b1024"):
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            dt.faiss_search("marco", K, data[name], params, catalog=cat)
            walls.append(1e3 * (time.perf_counter() - t0))
        # The stages of that search on the device, as the index runs them:
        # coarse top-k; list scan (K2 or K3) with its top-k and rerank; the
        # spill search (K5 and both rerank legs).
        xq_s, probe_s, _ = shapes[name]
        pairs = index.pairs_wanted(xq_s.shape[0], lmax)
        scan = ivf_sq_pairs_search if pairs else ivf_sq_list_search
        stages = {
            "coarse top-k": lambda: coarse_topk(xq_s, lay.centroids,
                                                SQ_NPROBE, metric),
            ("K3 scan + top-k + rerank" if pairs
             else "K2 fused search"): lambda: scan(
                lay.payload, lay.rn, lay.rs, lay.counts, lay.row_pos,
                probe_s, xq_s, None, vmin, scale, k=K, k_scan=k_scan,
                metric=metric, codec=codec),
            "K5 spill search (windows + rescore)": lambda: sq_spill_search(
                spill.payload, spill.assign, spill.pos, spill.rs, spill.rn,
                spill.n, probe_s, xq_s, None, vmin, scale, k=K,
                metric=metric, codec=codec, offsets=spill.offsets),
        }
        parts = []
        for label, fn in stages.items():
            fn()
            ms = statistics.median(cuda_ms(fn) for _ in range(5))
            parts.append(f"{label} {ms:.3f} ms")
        log(f"time IVF{SQ_NLIST},SQ8 {SQ_N}x{SQ_D} IP nprobe {SQ_NPROBE} "
            f"k={K} {name}: faiss_search wall {statistics.median(walls):.3f}"
            f" ms (median of 10); device stages (median CUDA events): "
            f"{'; '.join(parts)} [{smi}]")
    dt.config.pairs_impl = "mega"
    try:
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            dt.faiss_search("marco", K, data["b1024"], params, catalog=cat)
            walls.append(1e3 * (time.perf_counter() - t0))
    finally:
        dt.config.pairs_impl = "grid"
    log(f"time IVF{SQ_NLIST},SQ8 {SQ_N}x{SQ_D} IP nprobe {SQ_NPROBE} k={K} "
        f"b1024 pairs_impl mega: faiss_search wall "
        f"{statistics.median(walls):.3f} ms (median of 10) [{smi}]")
    dt.set_precision("parity")
    return {"launches": launches, "err": (max(max_err, raw2), raw3, raw5),
            "timings": timings}


def phase_marco_device(smi):
    """IVF4096,SQ8 IP over the full 8,841,823 x 1536 MS MARCO shape,
    ingested on the card (faiss_train_device / faiss_add_device with
    capped assignment) and searched at nprobe 16 through the public API in
    fast mode, b1024 under both pairs_impl values."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs_mega as k9
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.ops.ivf_sq_pairs import (
        ivf_sq_pairs_search)
    from duckdb_faiss_ext_tpu_torch.ops.ivf_sq_scan import ivf_sq_list_search
    from duckdb_faiss_ext_tpu_torch.ops.sq_digits import (KERNEL_SHIFT,
                                                          query_digits)
    from duckdb_faiss_ext_tpu_torch.ops.sq_spill import sq_spill_search
    from duckdb_faiss_ext_tpu_torch.utils.config import pad_rows

    metric, codec = "INNER_PRODUCT", "sq8"
    corpus = MarcoCorpus()
    xq_all = corpus.queries(BATCH * N_BATCHES + BIG_BATCH)
    data = {"b48": xq_all[:BATCH], "b1024": xq_all[-BIG_BATCH:],
            "batched": xq_all[:BATCH * N_BATCHES]}
    db = dt.Database()
    db.register("passages", {"id": np.arange(MARCO_N, dtype=np.int64)})
    cat = dt.Catalog()
    params = {"nprobe": str(SQ_NPROBE)}
    dt.faiss_create_params("marco", SQ_D, f"IVF{SQ_NLIST},SQ8",
                           {"assign_topk": str(MARCO_TOPK)},
                           metric_type=metric, catalog=cat)
    index = cat.get("marco").index
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dt.faiss_train_device(corpus.chunk(0), "marco", catalog=cat)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, n in corpus_chunks(MARCO_N):
        dt.faiss_add_device(corpus.chunk(i, n), "marco",
                            lmax=MARCO_LMAX if i == 0 else None, catalog=cat)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    t0 = time.perf_counter()
    lay = index._build_device_layout()
    torch.cuda.synchronize()
    t_layout = time.perf_counter() - t0
    spill = index._spill
    n_spill = spill.n if spill is not None else 0
    counts = index._counts()
    lmax = lay.payload.shape[1]
    check(index.ntotal == MARCO_N and lmax == MARCO_LMAX
          and index._layout_plan() == ("device", MARCO_LMAX),
          "device layout differs")
    log(f"marco device path: train_device {t_train:.2f} s, add_device of "
        f"{MARCO_N} rows in {len(corpus_chunks(MARCO_N))} chunks "
        f"{t_add:.2f} s, layout {t_layout:.2f} s; payload "
        f"{lay.payload.numel() / 1e9:.2f} GB (lmax {lmax}); lists: mean "
        f"{MARCO_N / SQ_NLIST:.0f}, longest {int(counts.max())}, "
        f"{int((counts > lmax).sum())} over lmax; spill {n_spill} rows "
        f"({100 * n_spill / MARCO_N:.3f}%); card memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    dt.set_precision("fast")

    def run_all():
        res = {"b48": dt.faiss_search("marco", K, data["b48"], params,
                                      catalog=cat),
               "b1024": dt.faiss_search("marco", K, data["b1024"], params,
                                        catalog=cat),
               "batched": dt.faiss_search_batched(
                   "marco", K, data["batched"], params, batch_size=BATCH,
                   catalog=cat)}
        dt.config.pairs_impl = "mega"
        try:
            res["b1024-mega"] = dt.faiss_search("marco", K, data["b1024"],
                                                params, catalog=cat)
            res["filter"] = dt.faiss_search_filter(
                "marco", K, data["b48"], "id%2==0", "id", "passages", params,
                catalog=cat, database=db)
        finally:
            dt.config.pairs_impl = "grid"
        return res

    k2.LAUNCHES = k2.TOPK_LAUNCHES = k3.LAUNCHES = k9.LAUNCHES = 0
    k5.LAUNCHES = k5.RESCORE_LAUNCHES = 0
    out = run_all()
    launches = (k2.TOPK_LAUNCHES, k3.LAUNCHES, k9.LAUNCHES, k5.LAUNCHES)
    check(k5.RESCORE_LAUNCHES == k5.LAUNCHES, "a spill search missed the "
          "rescore kernel")
    expected = (N_BATCHES + 2, 1, 1, (N_BATCHES + 4) if n_spill else 0)
    check(launches == expected and k2.LAUNCHES == 0, f"marco device path "
          f"launched (K2 fused, K3, K9, K5) {launches} times, not "
          f"{expected}, and K2's raw launch {k2.LAUNCHES} times")
    log(f"marco device path: (K2 fused, K3, K9, K5) launches {launches}")
    for key in ("label", "distance"):
        check(np.array_equal(out["b1024-mega"][key], out["b1024"][key]),
              f"mega and grid b1024 {key}s differ")

    t0 = time.perf_counter()
    with plain_sq_kernels():
        ref = run_all()
    check((k2.TOPK_LAUNCHES, k3.LAUNCHES, k9.LAUNCHES, k5.LAUNCHES)
          == launches and k2.LAUNCHES == 0
          and k5.RESCORE_LAUNCHES == launches[3],
          "the plain path launched a kernel")
    log(f"marco device path: plain path ({time.perf_counter() - t0:.1f} s)")
    max_err = 0.0
    for name, res in out.items():
        nq = data["b48" if name == "filter" else name.split("-")[0]].shape[0]
        check(res["label"].shape == (nq, K), f"{name}: shape")
        check(np.isfinite(res["distance"]).all(), f"{name}: non-finite")
        max_err = max(max_err, compare_same_k(f"marco {name}", res, ref[name],
                                              True))
        if name == "filter":
            check((res["label"] % 2 == 0).all(), "filter: odd label")
    log(f"marco device path: b48, b1024 (grid and mega, equal), batched and "
        f"filter agree with the plain path (max distance error "
        f"{max_err:.3g})")
    exact = {name: exact_ip_labels(corpus, data[name], K, MARCO_N)
             for name in ("b48", "b1024")}
    r48 = recall(out["b48"]["label"], exact["b48"])
    r1024 = recall(out["b1024"]["label"], exact["b1024"])
    log(f"marco device path: recall@10 vs exact fp32 search over the "
        f"{MARCO_N} rows: b48 {r48:.4f}, b1024 {r1024:.4f}")

    vmin, scale = index._sq_ranges()
    xq = torch.from_numpy(data["b1024"]).to(DEVICE)
    probe = coarse_topk(xq, lay.centroids, SQ_NPROBE, metric)
    q = query_digits(xq, vmin, scale, metric, codec, lay.payload.shape[2],
                     KERNEL_SHIFT[codec])
    tiles = k3.sq_pair_tile_inputs(probe, q, SQ_NLIST, metric)
    lists = (lay.payload, lay.rn, lay.rs, lay.counts)
    raw9 = k9_raw_error(*lists, tiles, None, metric, codec)
    n_tiles = int(tiles[2][0])
    log(f"marco device path b1024 raw tiles (lmax {lmax}, {n_tiles} of "
        f"{tiles[1].shape[0]} tiles): K9 bit-equal to its plain version and "
        f"to K3; K9 plan (stages, blocks, TMA) {k9.last_plan}")
    a3 = (*lists, *tiles[:3], None, metric, codec)
    ms9, plain_ms = time_pair(lambda: k9.ivf_sq_pairs_mega_scan(*a3),
                              lambda: k3.ivf_sq_pairs_scan_reference(*a3),
                              reps=4)
    ms9b, ms3 = time_pair(lambda: k9.ivf_sq_pairs_mega_scan(*a3),
                          lambda: k3.ivf_sq_pairs_scan(*a3), reps=10)
    _, once, rows_all = probed_rows(lay.counts, probe)
    w = lay.payload.shape[2]
    b9 = sq_bound(q, probe, 4 * n_tiles * tiles[1].shape[1] * lmax,
                  once * (w + 8), rows_all)
    log(f"time IVF{SQ_NLIST},SQ8 {MARCO_N}x{SQ_D} IP nprobe {SQ_NPROBE} "
        f"b1024 raw tiles (median CUDA events): K9 {ms9:.3f} ms, plain "
        f"{plain_ms:.3f} ms; in turns K9 {ms9b:.3f} ms against K3 "
        f"{ms3:.3f} ms (K3 {k3.last_blocks} blocks an SM, K9 plan "
        f"{k9.last_plan}); bound of both {b9[0]:.3f} ms ({b9[1]}) [{smi}]")
    xq48 = torch.from_numpy(pad_rows(data["b48"], 64)).to(DEVICE)
    probe48 = coarse_topk(xq48, lay.centroids, SQ_NPROBE, metric)
    k2_timing, err2 = time_k2(
        f"IVF{SQ_NLIST},SQ8 {MARCO_N}x{SQ_D} IP nprobe {SQ_NPROBE} b48", lay,
        xq48, probe48, vmin, scale, index._sq_kscan(K, SQ_NPROBE * lmax),
        metric, codec, smi)
    k5_timing = None
    if n_spill:
        spill_report(f"IVF{SQ_NLIST},SQ8 {MARCO_N}x{SQ_D} IP b48", spill,
                     vmin, scale, xq48, probe48, metric, codec, smi)
        k5_timing = spill_report(f"IVF{SQ_NLIST},SQ8 {MARCO_N}x{SQ_D} IP "
                                 f"b1024", spill, vmin, scale, xq, probe,
                                 metric, codec, smi)

    walls = {}
    for name, impl in (("b48", "grid"), ("b1024", "grid"), ("b1024", "mega")):
        dt.config.pairs_impl = impl
        try:
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                dt.faiss_search("marco", K, data[name], params, catalog=cat)
                times.append(1e3 * (time.perf_counter() - t0))
        finally:
            dt.config.pairs_impl = "grid"
        walls[f"{name} {impl}"] = statistics.median(times)
        nq_pad = 64 if name == "b48" else BIG_BATCH
        xq_s = torch.from_numpy(pad_rows(data[name], nq_pad)).to(DEVICE)
        probe_s = coarse_topk(xq_s, lay.centroids, SQ_NPROBE, metric)
        pairs = index.pairs_wanted(nq_pad, lmax)
        k_scan = index._sq_kscan(K, SQ_NPROBE * lmax)
        scan_name = ("K9" if impl == "mega" else "K3") if pairs else "K2"
        scan_label = (f"{scan_name} scan + top-k + rerank" if pairs
                      else "K2 fused search")
        stages = {
            "coarse top-k": lambda: coarse_topk(xq_s, lay.centroids,
                                                SQ_NPROBE, metric),
            scan_label: lambda: (
                ivf_sq_pairs_search(
                    *lists, lay.row_pos, probe_s, xq_s, None, vmin, scale,
                    k=K, k_scan=k_scan, metric=metric, codec=codec,
                    mega=impl == "mega") if pairs else ivf_sq_list_search(
                    *lists, lay.row_pos, probe_s, xq_s, None, vmin, scale,
                    k=K, k_scan=k_scan, metric=metric, codec=codec)),
        }
        if n_spill:
            stages["K5 spill search"] = lambda: sq_spill_search(
                spill.payload, spill.assign, spill.pos, spill.rs, spill.rn,
                spill.n, probe_s, xq_s, None, vmin, scale, k=K,
                metric=metric, codec=codec, offsets=spill.offsets)
        parts = []
        for label, fn in stages.items():
            fn()
            ms = statistics.median(cuda_ms(fn) for _ in range(5))
            parts.append(f"{label} {ms:.3f} ms")
        log(f"time IVF{SQ_NLIST},SQ8 {MARCO_N}x{SQ_D} IP nprobe {SQ_NPROBE} "
            f"k={K} {name} pairs_impl {impl}: faiss_search wall "
            f"{walls[f'{name} {impl}']:.3f} ms (median of 10); device stages "
            f"(median CUDA events): {'; '.join(parts)} [{smi}]")
    dt.set_precision("parity")
    return {"launches": launches[2], "err": max(max_err, raw9),
            "timing": (ms9, plain_ms, b9), "k5": k5_timing,
            "k2": (launches[0], err2, k2_timing)}


def k8_plain(args, kw, k):
    """K8's plain version (raw score block, top-k, resolve) on the same
    card tensors, one wider, padded with (-inf, -1) to k + 1 columns."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8
    from duckdb_faiss_ext_tpu_torch.ops.list_topk import pad_to

    return pad_to(*k8.ivf_pq_list_search_reference(*args, k=k + 1, **kw),
                  k + 1)


def k8_error(args, kw, k):
    """K8 (its table, partial and merge launches) against its plain version
    on the same card tensors (``compare``: scores within REL_TOL of each
    query's scale, positions equal where the scores are apart), and the
    table its first launch writes against ``pq_lut_reference`` within
    REL_TOL of Σ|q_t|·max|cb|.  Returns (max abs score error, queries the
    merge counted unproven)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    xq, cb, codec = args[6], args[3], kw["codec"]
    k8.reset_unproven(DEVICE)
    s, p = k8.ivf_pq_list_search(*args, k=k, **kw)
    unproven = k8.unproven(DEVICE)
    err = compare(s, p, *k8_plain(args, kw, k), xq)
    launch = k8.Launch(*args, k=k, **kw)
    launch.run(k8.TABLE)
    diff = float((launch.lut - k8.pq_lut_reference(xq, cb, codec)).abs()
                 .max())
    scale = float(xq.abs().sum(1).max() * cb.abs().max())
    check(diff <= REL_TOL * scale, f"K8 table error {diff} above tolerance")
    return err, unproven


def pq_sweep_layout(g, nlist, lmax, m, nbits, counts):
    """A padded (nlist, lmax, m) code layout for ``counts`` with duplicated
    rows (slots 4 and 5), and its row positions."""
    live = torch.arange(lmax, device=DEVICE)[None, :] < counts[:, None]
    lists = torch.randint(0, 1 << nbits, (nlist, lmax, m), device=DEVICE,
                          generator=g, dtype=torch.uint8)
    lists[:, 5] = lists[:, 4]
    lists *= live[:, :, None].to(torch.uint8)
    return lists, live_row_pos(counts, lmax)


def phase_pq_sweep():
    """K8 against its plain version, results and table: PQ (dsub 8 with 8
    bits, dsub 4 with 4 bits) and RQ (2 stages of 4 bits, 8 of 8), L2 / IP,
    mask off / on, d 16 / 128 / 1536 (the 1536-d PQ table with dsub 8, 192
    x 256 entries, is read from device memory, not shared memory), lmax
    256 and 1024 (counts on both sides of 256, 512 and 768), lists of count
    0 and count == lmax, duplicated rows, nprobe in turn 1 / 16 / 64, k in
    turn 10 / 1 / 100 / 1024; each case's unproven count is printed."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    g = torch.Generator(device=DEVICE).manual_seed(8642)
    nlist, nq = 64, BATCH
    before = k8.LAUNCHES
    err, n_cases = 0.0, 0
    nprobes = itertools.cycle((1, 16, 64))
    ks = itertools.cycle((10, 1, 100, 1024))
    for d, lmax in itertools.product(PQ_SWEEP_D, PQ_SWEEP_LMAX):
        t0 = time.perf_counter()
        counts = torch.randint(1, lmax, (nlist,), device=DEVICE, generator=g,
                               dtype=torch.int32)
        counts[0], counts[1] = 0, lmax
        if lmax > 256:
            counts[2:8] = torch.tensor([255, 257, 511, 513, 767, 769])
        mask = (torch.rand(nlist, lmax, device=DEVICE, generator=g)
                < 0.6).to(torch.int8)
        cents = torch.randn(nlist, d, device=DEVICE, generator=g)
        xq = torch.randn(nq, d, device=DEVICE, generator=g)
        unproven = []
        for codec, m_of, nbits in PQ_SWEEP_CODECS:
            m = m_of(d)
            lists, row_pos = pq_sweep_layout(g, nlist, lmax, m, nbits, counts)
            cb = torch.randn(m, 1 << nbits, d // m if codec == "pq" else d,
                             device=DEVICE, generator=g)
            rt = k8.pq_row_terms(lists, counts, cents, cb, codec)
            for metric, msk in itertools.product(("L2", "INNER_PRODUCT"),
                                                 (None, mask)):
                probe = probe_table(g, nq, nlist, next(nprobes))
                args = [lists, counts, row_pos, cb, cents, probe, xq, msk]
                kw = dict(metric=metric, codec=codec, row_terms=rt)
                e, u = k8_error(args, kw, next(ks))
                err = max(err, e)
                unproven.append(u)
                n_cases += 1
            del lists, cb, rt
        log(f"pq sweep d={d} lmax={lmax}: 16 cases agree, unproven queries "
            f"{unproven} ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    check(k8.LAUNCHES - before == n_cases, "a pq sweep case did not launch")
    log(f"pq sweep: {n_cases} cases, max abs score error K8 {err:.3g}")
    return err


@contextlib.contextmanager
def plain_k8():
    """Run the IVF-PQ / IVF-RQ path with K8's plain version in place of the
    fused call (same signature, same inputs)."""
    from duckdb_faiss_ext_tpu_torch.models import ivf_serve
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    saved = ivf_serve.ivf_pq_list_search
    ivf_serve.ivf_pq_list_search = k8.ivf_pq_list_search_reference
    try:
        yield
    finally:
        ivf_serve.ivf_pq_list_search = saved


def build_coded_ivf(dt, cat, name, factory, data, ids=None):
    """Create ``factory`` (L2), train it on the corpus's first IVF_TRAIN
    rows and add all of it; returns the IVF index and the setup seconds."""
    xb = data["xb"]
    t0 = time.perf_counter()
    dt.faiss_create(name, D, factory, metric_type="L2", catalog=cat)
    dt.faiss_manual_train(xb[:IVF_TRAIN], name, catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add((ids, xb) if ids is not None else xb, name, catalog=cat)
    t_add = time.perf_counter() - t0
    index = cat.get(name).index
    index = getattr(index, "inner", index)
    t0 = time.perf_counter()
    lay = index._build_device_layout()
    t_layout = time.perf_counter() - t0
    check(index._layout_plan() == ("full", None), f"{factory}: no full "
          f"layout plan")
    check(index.device.type == DEVICE, f"{factory}: index not on the card")
    log(f"{factory}: train {t_train:.2f} s, add {t_add:.2f} s (codes "
        f"{index._codes.nbytes / 1e6:.0f} MB), layout build+upload "
        f"{t_layout:.2f} s; lmax {lay.payload.shape[1]}, longest list "
        f"{int(lay.counts.max())}")
    return index, lay


def k8_shapes(index, lay, xq, nq_pad):
    """The b48 / b1024 batch as the index launches K8: padded queries, the
    coarse probe table, K8's arguments and keywords, and K8's bound for
    them.  Bytes, each moved once: the distinct probed lists' live codes,
    row terms and centroids, the codebooks, the queries, the probe table
    and the (nq, k) result.  Operations: the table build (2·nq·M·ksub·dsub
    for PQ, 2·nq·M·ksub·d for RQ), M + 2 adds a probed row, and the rescore
    of k + m candidates a query (4 a dimension, M more for RQ's stage
    sum)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.utils.config import pad_rows

    xq_pad = torch.from_numpy(pad_rows(xq, nq_pad)).to(DEVICE)
    probe = coarse_topk(xq_pad, lay.centroids, IVF_NPROBE, "L2")
    args = [lay.payload, lay.counts, lay.row_pos, lay.codebooks,
            lay.centroids, probe, xq_pad, None]
    kw = dict(metric="L2", codec=index.pq_codec, row_terms=lay.rt)
    m, ksub, w = lay.codebooks.shape
    lists_once, rows_once, rows_all = probed_rows(lay.counts, probe)
    per_dim = 4 + (m if index.pq_codec == "rq" else 0)
    b = bound(rows_once * (m + 4) + 4 * lists_once * D
              + 4 * lay.codebooks.numel() + 4 * nq_pad * D
              + 4 * probe.numel() + 8 * nq_pad * K,
              2 * nq_pad * m * ksub * w + (m + 2) * rows_all
              + nq_pad * (K + k8.margin(K)) * D * per_dim)
    return xq_pad, probe, args, kw, b


def time_k8(tag, index, lay, xq, nq_pad, search, smi):
    """K8 at one batch of a main path: held against its plain version
    (``k8_error``), its peak device memory against the (nq, nprobe, lmax)
    score block the TPU design wrote, then timed: K8 (its three launches)
    and its plain version in turns, the library call lists[probe_ids] (the
    TPU kernel's gather alone), ``search()``'s wall (faiss_search), the
    device stages (coarse top-k, table, partial, merge; CUDA events, and
    the three launches' device time from torch.profiler) and the fetch.
    Returns ((ms, plain_ms, bound, library_ms), max abs error)."""
    from duckdb_faiss_ext_tpu_torch.models.base import fetch_results
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk

    xq_pad, probe, args, kw, b = k8_shapes(index, lay, xq, nq_pad)
    err, unproven = k8_error(args, kw, K)
    lmax = lay.payload.shape[1]
    block = 4 * nq_pad * IVF_NPROBE * lmax
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k8.ivf_pq_list_search(*args, k=K, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(peak < block // 4, f"{tag}: K8 took {peak} bytes, near the "
          f"{block}-byte score block")
    ms, plain_ms = time_pair(
        lambda: k8.ivf_pq_list_search(*args, k=K, **kw),
        lambda: k8.ivf_pq_list_search_reference(*args, k=K, **kw),
        reps=6 if nq_pad < BIG_BATCH else 4)
    # The library call: the gather the TPU kernel did, as one indexing.
    probe_l = probe.long()
    lay.payload[probe_l]
    lib_ms = statistics.median(cuda_ms(lambda: lay.payload[probe_l])
                               for _ in range(6))
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        search()
        walls.append(1e3 * (time.perf_counter() - t0))
    launch = k8.Launch(*args, k=K, **kw)
    launch.run()
    best = (launch.scores, launch.positions)
    p = launch.plan
    stages = {"coarse top-k": lambda: coarse_topk(
                  xq_pad, lay.centroids, IVF_NPROBE, "L2"),
              "table": lambda: launch.run(k8.TABLE),
              "partial": lambda: launch.run(k8.PARTIAL),
              "merge": lambda: launch.run(k8.MERGE)}
    parts = []
    for label, fn in stages.items():
        fn()
        parts.append(f"{label} "
                     f"{statistics.median(cuda_ms(fn) for _ in range(5)):.3f}"
                     f" ms")
    # The launches' own device time (the stages above include the host's).
    device = device_ms(launch.run)
    fetch = []
    for _ in range(5):
        t0 = time.perf_counter()
        fetch_results(*best)
        fetch.append(1e3 * (time.perf_counter() - t0))
    log(f"time {tag} ({nq_pad} rows launched; {p['splits']} splits of "
        f"{p['warps']} warps): K8 {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library lists[probe_ids] {lib_ms:.3f} ms (median CUDA events), "
        f"bound {b[0]:.3f} ms ({b[1]}); agrees with the plain version (max "
        f"abs error {err:.3g}, unproven queries {unproven}); peak device "
        f"memory {peak / 2**20:.1f} MiB against a {block / 2**20:.0f} MiB "
        f"score block; faiss_search wall {statistics.median(walls):.3f} ms "
        f"(median of 10); device stages (median CUDA events): "
        f"{'; '.join(parts)}; fetch {statistics.median(fetch):.3f} ms (host "
        f"clock); device time a launch (torch.profiler): {device or 'none'} "
        f"[{smi}]")
    return (ms, plain_ms, b, lib_ms), err


def coded_path(dt, cat, name, data, params, db=None, k=K):
    """The main path's calls: b48, b1024 and (with a table) batched 16 x
    b48 and the filtered b48."""
    out = {"b48": dt.faiss_search(name, k, data["b48"], params, catalog=cat),
           "b1024": dt.faiss_search(name, k, data["b1024"], params,
                                    catalog=cat)}
    if db is not None:
        out["batched"] = dt.faiss_search_batched(
            name, k, data["batched"], params, batch_size=BATCH, catalog=cat)
        out["filter"] = dt.faiss_search_filter(
            name, k, data["b48"], "id%2==0", "id", "base", params,
            catalog=cat, database=db)
    return out


def check_coded_path(tag, dt, cat, name, data, params, out, exact, db=None):
    """Every result of ``out`` held against the same path with K8's plain
    version on the same layout, one wider; recall@10 against exact Flat
    printed.  Returns the max distance error."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    launches = k8.LAUNCHES
    t0 = time.perf_counter()
    with plain_k8():
        ref = coded_path(dt, cat, name, data, params, db, k=K + 1)
    check(k8.LAUNCHES == launches, f"{tag}: the plain path launched K8")
    max_err = 0.0
    for key, res in out.items():
        nq = data["b48" if key == "filter" else key].shape[0]
        check(res["label"].shape == (nq, K), f"{tag} {key}: shape")
        check(np.isfinite(res["distance"]).all(), f"{tag} {key}: non-finite")
        max_err = max(max_err, compare_results(
            f"{tag} {key}", res, ref[key]["distance"], ref[key]["label"],
            False))
        if key == "filter":
            check((res["label"] % 2 == 0).all(), f"{tag} filter: odd label")
    rec = {key: recall(out[key]["label"], exact[key]) for key in exact}
    log(f"{tag}: {', '.join(out)} agree with the plain path "
        f"({time.perf_counter() - t0:.1f} s; max distance error "
        f"{max_err:.3g}); recall@10 vs exact Flat: b48 {rec['b48']:.4f}, "
        f"b1024 {rec['b1024']:.4f}")
    return max_err


def phase_pq_main(smi, data, exact):
    """IDMap,IVF4096,PQ16 L2 over the 1M x 128 corpus at nprobe 64 through
    the public API; every result held against the plain K8 path; K8 held
    and timed at b48 and b1024 (``time_k8``)."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    ids = data["ids"]
    db = dt.Database()
    db.register("base", {"id": ids})
    cat = dt.Catalog()
    params = {"nprobe": str(IVF_NPROBE)}
    index, lay = build_coded_ivf(dt, cat, "pq", PQ_FACTORY, data, ids)

    k8.LAUNCHES = 0
    out = coded_path(dt, cat, "pq", data, params, db)
    launches = k8.LAUNCHES
    expected = 1 + 1 + N_BATCHES + 1
    check(launches == expected, f"pq main path launched K8 {launches} "
          f"times, not {expected}")
    check(index._last_scan_path == "per-query", "pq: not the K8 path")
    log(f"pq main path: K8 launches {launches}")
    max_err = check_coded_path("pq main path", dt, cat, "pq", data, params,
                               out, exact, db)

    timings, raw_err = {}, 0.0
    for name, nq_pad in (("b48", 64), ("b1024", BIG_BATCH)):
        timings[name], e = time_k8(
            f"IVF4096,PQ16 {N}x{D} L2 nprobe {IVF_NPROBE} k={K} {name}",
            index, lay, data[name], nq_pad,
            lambda: dt.faiss_search("pq", K, data[name], params,
                                    catalog=cat), smi)
        raw_err = max(raw_err, e)
    return {"launches": launches, "err": max(max_err, raw_err),
            "timings": timings, "cat": cat, "index": index,
            "params": params}


def phase_pq_spill(pq, data):
    """The IVF-PQ index with its layout capped below its longest list, so
    that those lists spill, searched at b48: held against the same index
    with no cap (K8 alone) and with no layout plan (the gather path)."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    cat, index, params = pq["cat"], pq["index"], pq["params"]
    # The references are one wider, so the k-th label is checked only
    # where the (k+1)-th distance is apart from it.
    whole = dt.faiss_search("pq", K + 1, data["b48"], params, catalog=cat)
    longest = int(index._counts().max())
    cap = 128
    while cap * 2 < longest:
        cap *= 2
    index.LAYOUT_BUDGET_BYTES = index.nlist * cap * index.pq_m
    index._invalidate()
    check(index._layout_plan() == ("spill", cap), "pq spill: no capped plan")
    k8.LAUNCHES = 0
    capped = dt.faiss_search("pq", K, data["b48"], params, catalog=cat)
    check(k8.LAUNCHES == 1, "pq spill: K8 not launched once")
    n_spill = index._spill.n
    check(n_spill > 0, "pq spill: nothing spilled")
    err = compare_results("pq spill vs uncapped", capped, whole["distance"],
                          whole["label"], False)
    index.SPILL_FRACTION_MAX = 0.0
    index._invalidate()
    check(index._layout_plan() is None, "pq spill: a plan without spill")
    gather = dt.faiss_search("pq", K + 1, data["b48"], params, catalog=cat)
    check(index._last_scan_path == "gather" and k8.LAUNCHES == 1,
          "pq spill: the gather path launched K8")
    err = max(err, compare_results("pq spill vs gather", capped,
                                   gather["distance"], gather["label"],
                                   False))
    log(f"pq spill: lists capped at {cap} (longest {longest}), {n_spill} "
        f"spill rows; b48 agrees with the uncapped K8 path and the gather "
        f"path (max distance error {err:.3g})")
    return err


def phase_rq_leg(smi, data, exact):
    """IVF4096,RQ8x8 L2 over the same corpus (beam-4 encode on the card),
    b48 and b1024 through K8, held against the plain K8 path; K8 held and
    timed at b1024 (``time_k8``)."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    cat = dt.Catalog()
    params = {"nprobe": str(IVF_NPROBE)}
    index, lay = build_coded_ivf(dt, cat, "rq", RQ_FACTORY, data)
    k8.LAUNCHES = 0
    out = coded_path(dt, cat, "rq", data, params)
    check(k8.LAUNCHES == 2, f"rq leg launched K8 {k8.LAUNCHES} times, not 2")
    max_err = check_coded_path("rq leg", dt, cat, "rq", data, params, out,
                               exact)
    _, raw_err = time_k8(
        f"IVF4096,RQ8x8 {N}x{D} L2 nprobe {IVF_NPROBE} k={K} b1024", index,
        lay, data["b1024"], BIG_BATCH,
        lambda: dt.faiss_search("rq", K, data["b1024"], params, catalog=cat),
        smi)
    return max(max_err, raw_err)


def phase_pq_standalone(data):
    """Standalone PQ16 (pq_search on card tensors) at b48: labels equal to
    a Flat search (K1) over its decoded corpus where distances are
    separated."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops.pq import codec_decode

    xb = data["xb"]
    cat = dt.Catalog()
    t0 = time.perf_counter()
    dt.faiss_create("pq16", D, "PQ16", metric_type="L2", catalog=cat)
    dt.faiss_manual_train(xb[:IVF_TRAIN], "pq16", catalog=cat)
    dt.faiss_add(xb, "pq16", catalog=cat)
    index = cat.get("pq16").index
    check(index.device.type == DEVICE, "pq16: index not on the card")
    res = dt.faiss_search("pq16", K, data["b48"], catalog=cat)
    codes, books = index._device_state()
    decoded = codec_decode(codes[:N], books, "pq").cpu().numpy()
    dt.faiss_create("decoded", D, "Flat", metric_type="L2", catalog=cat)
    dt.faiss_add(decoded, "decoded", catalog=cat)
    before = ft.LAUNCHES
    ref = dt.faiss_search("decoded", K + 1, data["b48"], catalog=cat)
    check(ft.LAUNCHES == before + 1, "pq16: the Flat search missed K1")
    check(np.isfinite(res["distance"]).all(), "pq16: non-finite")
    err = compare_results("pq16 vs Flat over decoded", res, ref["distance"],
                          ref["label"], False)
    log(f"pq16 standalone: b48 agrees with K1 over the decoded corpus (max "
        f"distance error {err:.3g}; {time.perf_counter() - t0:.1f} s with "
        f"train and add)")
    return err


def main():
    smi = phase_environment()
    phase_build()
    sweep_err = phase_sweep()
    golden_err = phase_golden()
    data = main_path_data()
    main_err, launches, timings, exact = phase_main_path(smi, data)
    phase_time_1536(smi)
    err6, err7 = phase_ivf_sweep()
    err10 = phase_ivf_mega_sweep()
    ivf_err, ivf_err7, ivf_launches, ivf_timings = phase_ivf_main(smi, data,
                                                                  exact)
    torch.cuda.empty_cache()
    pq_sweep_err = phase_pq_sweep()
    pq = phase_pq_main(smi, data, exact)
    pq_spill_err = phase_pq_spill(pq, data)
    del pq["cat"], pq["index"]
    torch.cuda.empty_cache()
    rq_err = phase_rq_leg(smi, data, exact)
    torch.cuda.empty_cache()
    phase_pq_standalone(data)
    del data
    torch.cuda.empty_cache()
    ((pairs_err, pairs_launches, pairs_timing, pairs_before),
     (mega_err, mega_launches, mega_timing, mega_before)) = phase_ivf_pairs(
        smi)
    torch.cuda.empty_cache()
    sq_errs = phase_sq_sweep()
    err9 = phase_sq_mega_sweep()
    sq = phase_sq_main(smi)
    torch.cuda.empty_cache()
    marco = phase_marco_device(smi)
    log(smi)
    # Flat, K6 and the SQ kernels at the shapes timed above; no single
    # PyTorch call computes what K2-K7, K9 and K10 compute (a distance, a
    # selection and a layout walk), so their library_ms is null.
    pq_ms, pq_plain_ms, pq_bound, pq_lib_ms = pq["timings"]["b1024"]
    # K6, K2, K7 and K10: the fused search's time, and beside it
    # (before_ms) the design it replaced (raw launch, torch top-k, resolve
    # or rerank, or the pair epilogue), timed in turns with it.
    k6_ms, k6_plain, k6_bound, k6_before_ms = ivf_timings["b1024"]
    k2_ms, k2_plain, k2_bound, k2_before_ms = sq["timings"]["k2"]
    print(json.dumps({"kernels": [
        kernel_entry(KERNEL, launches, max(sweep_err, golden_err, main_err),
                     *timings["b1024"]),
        kernel_entry(IVF_LIST_KERNEL, ivf_launches, max(err6, ivf_err),
                     k6_ms, k6_plain, k6_bound, before_ms=k6_before_ms),
        kernel_entry(IVF_PAIRS_KERNEL, pairs_launches,
                     max(err7, ivf_err7, pairs_err), *pairs_timing,
                     before_ms=pairs_before),
        kernel_entry(SQ_LIST_KERNEL, sq["launches"][0],
                     max(sq_errs[0], sq["err"][0], marco["k2"][1]), k2_ms,
                     k2_plain, k2_bound, before_ms=k2_before_ms),
    ] + [
        kernel_entry(kernel, sq["launches"][i],
                     max(sq_errs[i], sq["err"][i]), *sq["timings"][key])
        for i, (kernel, key) in ((1, (SQ_PAIRS_KERNEL, "k3")),
                                 (2, (SQ_SPILL_KERNEL, "k5")))
    ] + [
        kernel_entry(PQ_KERNEL, pq["launches"],
                     max(pq_sweep_err, pq["err"], pq_spill_err, rq_err),
                     pq_ms, pq_plain_ms, pq_bound, pq_lib_ms),
        kernel_entry(SQ_MEGA_KERNEL, marco["launches"],
                     max(err9, marco["err"]), *marco["timing"]),
        kernel_entry(FLAT_MEGA_KERNEL, mega_launches, max(err10, mega_err),
                     *mega_timing, before_ms=mega_before),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
