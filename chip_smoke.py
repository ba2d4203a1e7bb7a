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
   the k-th exact score); then the forced margin case, L2 and inner
   product at k = 10, d = 1536: 65,536 ordinary rows and, for each of 8
   queries, a cluster of 512 rows whose exact scores form a ladder three
   compare tolerances apart (L2: far from the origin, where the expansion
   form cancels; inner product: far along a direction orthogonal to the
   query), so that more rows than K1's pool lie within twice its error
   bound of the k-th score: every query must count unproven, and the
   result must still agree with the plain version (``compare``);
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
   search bit-equal to K7's and held against the plain version; the sweep
   ends with phase 3's forced margin case for the fused K7 and K10 (each
   query's cluster in one of 16 lists of 1024 rows, nprobe 4, k_scan 42),
   each query counted unproven by both, results held against the plain
   version with ``compare``'s per-query scale;
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
   margin-unproven queries is printed; then phase 3's forced margin case
   for K8 (IVF-PQ192 x 8 bits at d = 1536, each query's cluster 512 rows
   of one list that share their codes but in two subquantizers whose
   entries make the ladder), each query counted unproven, results held
   against the plain version;
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
   pairs_impl values;
17. standalone SQ (after phase 15, on its corpus): SQ8 / SQ4 / SQ6 /
   SQfp16 / SQbf16 L2 through the public API at b48 and b1024 and
   filtered 'id%2==0': the parity decode path, and for the quantized
   codecs the int8 path (fast mode): the parity path held against K1 over
   the index's decoded corpus, the int8 path against K1's best 40 rows
   rescored in fp64 (labels equal where the distances are apart; K1's own
   error against fp64 printed), with wall times and peak card memory; a save → load round trip on the card
   (SQ8, SQbf16); then SQ8 inner product over the first 1,048,576 rows of
   phase 10's 1536-d corpus (1.5 GB of codes) the same way;
18. SQL shell and harness (after phase 7, with its index): the golden
   corpus through sql.dispatch.connect() gives phase 4's distances, labels
   and filtered rows; run_filtered_bench over the 1M x 128 IDMap,Flat at
   pass rates 0.5 / 0.1 / 0.01 with K1's launch count checked (the
   selectors and the post-filter where its k' is within K1's limit) and
   each strategy's qps printed; a TREC run of Flat scored against exact
   qrels with recall 1.0; autotune_index over phase 7's IVF4096 index,
   every search through the fused K6;
19. port bench: ``python3 -m duckdb_faiss_ext_tpu_torch.bench`` as a
   subprocess under a time limit; its one JSON line must parse and is
   printed, its ivf_recall beside phase 7's;
20. refine pipeline (after phase 17, on phase 7's corpus):
   OPQ16,IVF4096,PQ16,RFlat L2 (examples/compression_pipeline.py:42 at phase
   12's size), trained on the first 262,144 rows, nprobe 64, k_factor 8
   (k_base 80), b48 and b1024: K8's launch count and path checked, results
   held against the same index with K8's plain version one wider at the
   same k_base, recall@10 against phase 5's exact labels printed; then
   PCA64,Flat L2 and L2norm,Flat IP, K1's launches counted and results
   held against K1's plain version on the transformed corpus (recall 1.0);
21. MS MARCO refine tier (after phase 10): IVF4096,SQ8,RFlat IP over phase
   10's 2,097,152 x 1536 corpus, the base loaded with phase 10's trained
   centroids and SQ ranges through load_state (no second k-means), the raw
   store 12.9 GB beside 3.2 GB of codes, fast mode, nprobe 16, k_factor 4:
   b48 through the fused K2 and b1024 through K3 (the base's scan path
   printed), K5 on the spill rows, launch counts checked, results held
   against the plain K2 / K3 / K5 path, recall@10 against phase 10's exact
   labels beside phase 10's;
22. IMI and SOAR (on phase 7's corpus): IMI2x7,Flat L2 (16,384 cells,
   lists capped at 1024 slots, the overflow spilled) at nprobe 256, and
   IVF4096,Flat with soar_lambda 1.0 on phase 7's centroids (2M storage
   rows, lists capped where more than a tenth of the rows would overflow)
   at nprobe 16 and 64, b48 and b1024: the fused K6 / K7 launch counts as
   the static rule and query blocks predict, results held against the
   plain K6 / K7 path one wider, no label twice in a query, the layout's
   lmax, padded bytes and spill printed, recall@10 beside phase 7's;
23. LSH: LSHrt (128 bits) and ITQ64,LSH over phase 7's corpus, b48 and
   b1024: the Hamming distances equal exactly to a plain bit count on the
   card (packed codes, XOR, popcount), labels tie-aware;
24. range search at b48, the radius the median of the plain path's 10th
   distance: phase 5's IDMap,Flat (also with the id%2==0 selector), phase
   7's IVF4096 and phase 12's IVF4096,PQ16 at nprobe 64, phase 17's SQ8 and
   phase 22's SOAR index; each CSR held per query against a plain dense
   scan on the card (rows within the tolerance of the radius left out),
   the result count and wall time printed; one statement through
   sql.dispatch;
25. graph (after phase 24, on phase 5's corpus and exact labels): the
   reference's benchmark config IDMap,HNSW128,Flat L2 (efConstruction
   128, BASELINE.md:14) through faiss_create_params → faiss_add with ids
   → the first faiss_search, which builds the graph (degree 128 from an
   intermediate 192, the exact k-NN scan on K1: its launches counted,
   build seconds and adjacency bytes printed); walks at efSearch 16 / 64 /
   128, b48 and b1024 (no K1 launch; every distance the fp32 distance of
   its row, no label twice; recall@10 against phase 5's exact labels, at
   least 0.90 at efSearch 64; pool, width, iterations, wall and device
   time an iteration printed); faiss_search_batched 16 x b48 bit-equal
   to the sequential calls; faiss_search_filter('id%2==0') all even;
   {"exact": "true"} one K1 launch with phase 5's labels; 10,000 rows
   added, then a search merges them through one K1 launch without a
   rebuild; a faiss_save / faiss_load round trip with equal results and
   no rebuild.  Then the same graph code (HNSW32's degree) over the first
   32,768 rows on the card and on the CPU: the k-NN graphs equal where
   the neighbouring distances are apart, augment_graph byte-equal, and
   the walk over the card's adjacency equal on both.  Then
   IVF2048_HNSW128,Flat L2 (the reference's other benchmark config:
   nprobe 15, quantiser.efSearch 64) trained on the first 262,144 rows:
   K6 / K7 launch counts as the static rule predicts, results held
   against the plain path one wider, recall@10.  Then NSG32 inner product
   over phase 8's 262,144 x 1536 corpus (search_L 64; its build on K1)
   and HNSW32 with accel=ivf on it (an internal IVF512, K6 launched), at
   b48 and b1024, recall@10 against K1's exact labels, walls, device
   time an iteration, build seconds and card peaks printed;
26. placement (faiss_to_device; after phase 24, on the main paths'
   indexes, and, for its SQ leg, after phase 21): phase 5's IDMap,Flat
   under faiss_to_device(name) (one shard on the card), a 4 x 1 and a 2 x
   2 mesh of cuda:0 (K1 on every block; launches a search and walls
   beside the unplaced search's), phase 7's IDMap,IVF4096,Flat and phase
   12's IDMap,IVF4096,PQ16 placed 4 ways with LPT (per-shard Σcounts and
   max/mean printed; b48, b1024 and a 50% BitmapSelector filter built by
   create_mask through the native bitmapper; K6 / K7 and K8 launches),
   every result held against the same index unplaced (labels equal where
   the distances are apart); IDMap,HNSW128,Flat over the same corpus in
   graph_sharded over 4 shards (four per-shard builds on K1: build
   seconds, launches, recall@10 against exact and walk walls at b48 and
   b1024); multichip_dryrun(4) on cuda:0 repeated; the two-process
   multihost demo as a subprocess (each rank its hash_partition half of
   a 1M x 128 corpus, gloo, MULTIHOST OK); IVF1024,SQ8 IP over the first
   1,048,576 rows of phase 10's generator placed 4 ways in fast mode (K2
   at b48, K3 at b1024 on every shard; no rank worse than unplaced,
   equal wherever the distances agree); and in phase 16 the MS MARCO
   device index filtered by id%2==0 with its layout and spill masks built
   on the card and on the host (both timed, first call and again; results
   equal).

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
profiler's reading.  Phase 26's placed paths add their launches to K1,
K6 / K7, K2 / K3 and K8.  The last two lines of standard output are a JSON
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
#: the corpus (duckdb_faiss_ext_tpu_torch/tools/marco_corpus.py): unit
#: vectors around 4096 unit centres (noise of norm 0.8), lognormal cluster
#: weights (sigma 0.7) in the training chunk, drifted by a lognormal factor
#: (sigma 0.5) in the later chunks, so that lists differ in length and the
#: longest outgrow the cap (11.5% of the rows spill; the JAX deployment
#: spilled 12% at SQ8, ops/pallas_spill.py:6)
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
#: phase 16's TREC run: k of the reference's create_trec flow
MARCO_TREC_K = 1000
MARCO_LMAX = 512 * -(-int(1.15 * MARCO_N) // (SQ_NLIST * 512))
#: the forced margin cases of phases 3, 6 and 11: each of FORCED_NQ
#: queries sits on a cluster of FORCED_CLUSTER rows far from the origin
#: (L2) or far along a direction orthogonal to the query (inner product),
#: whose exact scores form a ladder FORCED_STEP compare tolerances apart,
#: so that more rows than the kernel's pool lie within twice its error
#: bound E of the k-th exact score while every pair of neighbours stays
#: far enough apart for compare to see a wrong order; the rest of the
#: corpus (FORCED_N rows, or the other slots of the lists) is ordinary
FORCED_N, FORCED_D, FORCED_NQ, FORCED_CLUSTER = 65_536, 1536, 8, 512
FORCED_STEP = 3.0
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


def forced_frame(seed, nq, d):
    """2·nq orthonormal directions (v_i, w_i) of R^d, float32 on DEVICE
    (float64 QR of a seeded Gaussian on the host)."""
    g = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(g.standard_normal((d, 2 * nq)))
    t = torch.from_numpy(np.ascontiguousarray(basis.T, np.float32)).to(
        DEVICE)
    return t[:nq], t[nq:]


def ladder(metric, nq, tol):
    """(FORCED_CLUSTER,) offsets t along w_i of the cluster rows: L2 rows
    at c + t w from a query at c score -t² = -(1 + j·step); inner product
    rows at c − t w score c·w − j·step; step FORCED_STEP·tol."""
    j = torch.arange(FORCED_CLUSTER, device=DEVICE, dtype=torch.float32)
    step = FORCED_STEP * tol
    return (1.0 + j * step).sqrt() if metric == "L2" else j * step


def forced_check(name, ref_s, k, pool, e, tol):
    """The forced case's premise on the plain version's scores (nq, ≥ pool
    + 1), best first: the pool's last score within 2E of the k-th for
    every query (so a kernel cannot prove its k-th from its pool), and
    every pair of neighbours among the best pool + 1 more than twice
    compare's tolerance apart.  Returns the least count of rows within 2E
    of a query's k-th score."""
    ek = ref_s[:, k - 1:k]
    check(bool((ref_s[:, pool - 1:pool] >= ek - 2 * e[:, None]).all()),
          f"{name}: the case does not force the margin")
    gaps = (ref_s[:, :pool] - ref_s[:, 1:pool + 1]).min(1).values
    check(bool((gaps > 2 * tol).all()), f"{name}: neighbours closer than "
          f"twice the tolerance ({float(gaps.min()):.3g})")
    return int((ref_s >= ek - 2 * e[:, None]).sum(1).min())


def forced_flat_case(metric):
    """K1's forced case: FORCED_N ordinary rows (standard normal) with a
    ladder cluster for each query at random positions; K1 against its plain
    version (``compare``), its unproven count printed."""
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft

    v, w = forced_frame(11 if metric == "L2" else 12, FORCED_NQ, FORCED_D)
    g = torch.Generator(device=DEVICE).manual_seed(13)
    xb = torch.randn(FORCED_N, FORCED_D, device=DEVICE, generator=g)
    if metric == "L2":
        cents, xq = 100.0 * v, 100.0 * v
        tol = REL_TOL * (xq * xq).sum(1).max()
    else:
        cents, xq = 50.0 * v + 10.0 * w, w.clone()
        tol = torch.tensor(REL_TOL * 10.0, device=DEVICE)
    t = ladder(metric, FORCED_NQ, tol)
    sign = 1.0 if metric == "L2" else -1.0
    rows = cents[:, None, :] + sign * t[None, :, None] * w[:, None, :]
    at = torch.randperm(FORCED_N, device=DEVICE, generator=g)
    xb[at[:FORCED_NQ * FORCED_CLUSTER]] = rows.reshape(-1, FORCED_D)
    pool = K + ft.margin(K)
    ft.reset_unproven(DEVICE)
    s, p = ft.flat_topk(xb, FORCED_N, xq, K, metric)
    unproven = ft.unproven(DEVICE)
    rs, rp = ft.flat_topk_reference(xb, FORCED_N, xq, FORCED_CLUSTER, metric)
    e = ft.error_bound((xq * xq).sum(1), float((xb * xb).sum(1).max()),
                       FORCED_D, metric)
    within = forced_check(f"K1 {metric}", rs, K, pool, e, tol)
    check(unproven == FORCED_NQ, f"K1 {metric}: {unproven} of {FORCED_NQ} "
          f"forced queries counted unproven")
    err = compare(s, p, rs[:, :K + 1], rp[:, :K + 1], xq)
    log(f"forced margin K1 {metric} d={FORCED_D} k={K}: {unproven} of "
        f"{FORCED_NQ} queries unproven, at least {within} rows within 2E "
        f"of the k-th score (pool {pool}), result agrees with the plain "
        f"version (max abs error {err:.3g})")
    return err


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
    for metric in ("L2", "INNER_PRODUCT"):
        max_err = max(max_err, forced_flat_case(metric))
    torch.cuda.empty_cache()
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
    data["flat_cat"] = cat   # phase 24's IDMap,Flat
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
                  k_scan, batch=True):
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
    return compare(s, p, *ref, xq, batch=batch), p


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


def forced_pairs_case(metric):
    """The fused K7 / K10's forced case: 16 lists of 1024 ordinary rows,
    query i's ladder cluster in random slots of list i, each query probing
    its list and three of lists 8-15, k_scan 42; K7 against its plain
    version and K10 bit-equal (``k7_topk_error``), its unproven count
    printed."""
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    nlist, lmax, nprobe = 16, 1024, 4
    k_scan = max(4 * K, K + 32)
    v, w = forced_frame(21 if metric == "L2" else 22, FORCED_NQ, FORCED_D)
    g = torch.Generator(device=DEVICE).manual_seed(23)
    lists = torch.randn(nlist, lmax, FORCED_D, device=DEVICE, generator=g)
    counts = torch.full((nlist,), lmax, dtype=torch.int32, device=DEVICE)
    row_pos = live_row_pos(counts, lmax)
    if metric == "L2":
        cents, xq = 100.0 * v, 100.0 * v
        tol = REL_TOL * float((xq * xq).sum(1).max())
    else:
        cents, xq = 50.0 * v + 10.0 * w, w.clone()
        tol = REL_TOL * 10.0
    t = ladder(metric, FORCED_NQ, torch.tensor(tol, device=DEVICE))
    sign = 1.0 if metric == "L2" else -1.0
    for i in range(FORCED_NQ):
        slots = torch.randperm(lmax, device=DEVICE,
                               generator=g)[:FORCED_CLUSTER]
        lists[i, slots] = cents[i] + sign * t[:, None] * w[i]
    others = torch.rand(FORCED_NQ, nlist - FORCED_NQ, device=DEVICE,
                        generator=g).argsort(1)[:, :nprobe - 1]
    probe = torch.cat([torch.arange(FORCED_NQ, device=DEVICE)[:, None],
                       FORCED_NQ + others], 1).to(torch.int32).contiguous()
    unproven = []
    for mega in (False, True):
        k7.reset_unproven(DEVICE)
        k7.ivf_pairs_search(lists, counts, row_pos, probe, xq, None, k=K,
                            k_scan=k_scan, metric=metric, mega=mega)
        unproven.append(k7.unproven(DEVICE))
    err, _ = k7_topk_error(lists, counts, row_pos, probe, xq, None, metric,
                           K, k_scan, batch=False)
    ref_s, _ = k7.ivf_pairs_search_reference(
        lists, counts, row_pos, probe, xq, None, k=FORCED_CLUSTER,
        k_scan=FORCED_CLUSTER, metric=metric)
    bn_max = float((lists[probe.long()] ** 2).sum(-1).max())
    e = ft.error_bound((xq * xq).sum(1), bn_max, FORCED_D, metric)
    within = forced_check(f"K7 {metric}", ref_s, K, k_scan, e, tol)
    check(unproven == [FORCED_NQ] * 2, f"K7 / K10 {metric}: {unproven} of "
          f"{FORCED_NQ} forced queries counted unproven")
    log(f"forced margin K7 = K10 {metric} d={FORCED_D} k={K}: {unproven[0]}"
        f" (K7) and {unproven[1]} (K10) of {FORCED_NQ} queries unproven, at "
        f"least {within} rows within 2E of the k-th score (pool {k_scan}), "
        f"result agrees with the plain version (max abs error {err:.3g})")
    return err


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
    for metric in ("L2", "INNER_PRODUCT"):
        err7f = max(err7f, forced_pairs_case(metric))
    torch.cuda.empty_cache()
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
    recalls = {}
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
        recalls[name] = recall
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
    return (max(max_err, raw_err6), raw_err7, launches[0], timings,
            {"cat": cat, "recall": recalls["b48"]})


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


def marco_corpus(seed=11):
    """The SQ main paths' corpus (duckdb_faiss_ext_tpu_torch/tools/
    marco_corpus.py, the tools' generator), made on the card chunk by chunk
    at SQ_D with SQ_NLIST centres in SQ_CHUNK-row chunks, so any chunk can
    be made again for exact search."""
    from duckdb_faiss_ext_tpu_torch.tools.marco_corpus import MarcoCorpus

    return MarcoCorpus(seed, device=DEVICE, d=SQ_D, centers=SQ_NLIST,
                       chunk_rows=SQ_CHUNK)


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
    return corpus.exact_ip_labels(xq, k, n_rows)


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
    corpus = marco_corpus()
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
            "timings": timings, "exact": exact,
            "recall": {"b48": r48, "b1024": r1024},
            "state": {"centroids": index._centroids,
                      "sq_vmin": index._sq_vmin,
                      "sq_scale": index._sq_scale}}


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
    corpus = marco_corpus()
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
    marco_masks(smi, cat, index, data, params, db)
    trec = marco_trec(smi, cat, data, exact)
    dt.set_precision("parity")
    return {"launches": launches[2], "err": max(max_err, raw9),
            "timing": (ms9, plain_ms, b9), "k5": k5_timing,
            "k2": (launches[0], err2, k2_timing), "trec": trec,
            "queries": {name: data[name] for name in ("b48", "b1024")},
            "exact": exact}


def marco_trec(smi, cat, data, exact):
    """Phase 16's k = 1000 TREC run (tools/marco_trec.py's flow through
    harness.trec): the b48 and b1024 queries each in one search call at
    nprobe 16, k_scan 4000, so past the fused kernels' 1024: the raw K2
    launch at b48, K3 at b1024.  The spill takes the plain spill scan, as
    in the JAX package (its spill kernel serves k <= 128,
    duckdb_faiss_ext_tpu/models/ivf_serve.py:324), so K5 is not launched.
    Qrels graded from the exact top-10 (3 x grade 3, 7 x grade 2);
    MRR@10, nDCG@10 and recall@1000 printed.  Returns the (K2 raw, K3)
    launches."""
    import tempfile

    from duckdb_faiss_ext_tpu_torch.harness.trec import (score_trec_run,
                                                         write_trec_run)
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5

    def counts():
        return (k2.LAUNCHES, k2.TOPK_LAUNCHES, k3.LAUNCHES, k5.LAUNCHES,
                k5.RESCORE_LAUNCHES)

    params = {"nprobe": str(SQ_NPROBE)}
    total = np.zeros(5, np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("b48", "b1024"):
            xq = data[name]
            qids = [f"{name}-{i}" for i in range(xq.shape[0])]
            qrels = {qid: {str(int(doc)): 3 if r < 3 else 2
                           for r, doc in enumerate(row[:10])}
                     for qid, row in zip(qids, exact[name])}
            path = os.path.join(tmp, f"{name}.run")
            before = np.array(counts())
            t0 = time.perf_counter()
            write_trec_run(path, "marco", qids, xq, k=MARCO_TREC_K,
                           run_name="dfx-sq8", params=params, catalog=cat,
                           batch=xq.shape[0])
            sec = time.perf_counter() - t0
            got = tuple(int(v) for v in np.array(counts()) - before)
            total += got
            with open(path) as f:
                lines = f.read().splitlines()
            check(len(lines) == xq.shape[0] * MARCO_TREC_K,
                  f"TREC {name}: {len(lines)} run lines, not "
                  f"{xq.shape[0] * MARCO_TREC_K}")
            want = (int(name == "b48"), 0, int(name == "b1024"), 0, 0)
            check(got == want, f"TREC {name} launched (K2 raw, K2 "
                  f"fused, K3, K5 windows, K5 rescore) {got} times, "
                  f"not {want}")
            sc = score_trec_run(path, qrels, recall_k=MARCO_TREC_K)
            check(sc["nq"] == xq.shape[0] and sc["mrr@10"] > 0.5,
                  f"TREC {name}: scores {sc}")
            log(f"marco TREC run k={MARCO_TREC_K} {name} ({xq.shape[0]} "
                f"queries, one search call, nprobe {SQ_NPROBE}, k_scan "
                f"{cat.get('marco').index._sq_kscan(MARCO_TREC_K, 1 << 30)}"
                f"): written in {sec:.2f} s; (K2 raw, K2 fused, K3, K5 "
                f"windows, K5 rescore) launches {got}; TREC scores "
                f"mrr@10={sc['mrr@10']:.4f} ndcg@10={sc['ndcg@10']:.4f} "
                f"recall@{MARCO_TREC_K}={sc[f'recall@{MARCO_TREC_K}']:.4f} "
                f"[{smi}]")
    return int(total[0]), int(total[2])


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


def forced_pq_case(metric):
    """K8's forced case: IVF-PQ with d = 1536, M = 192 (dsub 8), 8 bits, 16
    lists of 1024 rows with random codes; query i's cluster is 512 rows of
    list i sharing codes f_i beyond their first two subquantizers, whose
    entries make the ladder (subquantizer 0 steps of 2h over its 256
    entries, subquantizer 1 adds 0 or h), each query probing its list and
    three of lists 8-15; K8 against its plain version (``k8_error``), its
    unproven count printed."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8

    nlist, lmax, nprobe, m, ksub, dsub = 16, 1024, 4, FORCED_D // 8, 256, 8
    gen = np.random.default_rng(31 if metric == "L2" else 32)
    g = torch.Generator(device=DEVICE).manual_seed(33)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(DEVICE)

    cb = gen.standard_normal((m, ksub, dsub)).astype(np.float32)
    f = gen.integers(0, ksub, (FORCED_NQ, m))
    dec_f = cb[np.arange(m), f].reshape(FORCED_NQ, FORCED_D)  # (nq, d)
    e0, e1 = (u / np.linalg.norm(u) for u in gen.standard_normal((2, dsub)))
    lists = torch.randint(0, ksub, (nlist, lmax, m), device=DEVICE,
                          generator=g, dtype=torch.uint8)
    if metric == "L2":
        # Query i at c_i + dec(f_i) with its first two subspaces at c_i:
        # cluster row (j, a) scores -(s0 + (2j + a) h).
        cents = gen.standard_normal((nlist, FORCED_D))
        cents *= 100.0 / np.linalg.norm(cents, axis=1, keepdims=True)
        xq = cents[:FORCED_NQ] + dec_f
        xq[:, :2 * dsub] = cents[:FORCED_NQ, :2 * dsub]
        h = FORCED_STEP * REL_TOL * float((xq * xq).sum(1).max())
        cb[0] = np.sqrt(1.0 + 2 * h * np.arange(ksub))[:, None] * e0
        cb[1, 0], cb[1, 1] = 0.0, np.sqrt(h) * e1
    else:
        # Query i: e0 and e1 in its first two subspaces, a random part of
        # norm 1 beyond; centroids of norm ~50 orthogonal to the queries
        # but for a component that lifts query i's own list to 10; the
        # other rows of every list drop by 20 in subspace 1.
        rest = gen.standard_normal((FORCED_NQ, FORCED_D - 2 * dsub))
        rest /= np.linalg.norm(rest, axis=1, keepdims=True)
        xq = np.concatenate([np.tile(np.concatenate([e0, e1]),
                                     (FORCED_NQ, 1)), rest], 1)
        cents = gen.standard_normal((nlist, FORCED_D))
        qb, _ = np.linalg.qr(xq.T)
        cents -= (cents @ qb) @ qb.T
        cents *= 50.0 / np.linalg.norm(cents, axis=1, keepdims=True)
        h = FORCED_STEP * REL_TOL * 10.0
        cb[0] = -2 * h * np.arange(ksub)[:, None] * e0
        cb[1, 0], cb[1, 1], cb[1, 2:] = 0.0, -h * e1, -20.0 * e1
        lists[:, :, 1] = torch.randint(2, ksub, (nlist, lmax), device=DEVICE,
                                       generator=g, dtype=torch.uint8)
        own = (xq[:, 2 * dsub:] * dec_f[:, 2 * dsub:]).sum(1)
        cents[:FORCED_NQ] += ((10.0 - own) / 2.0)[:, None] * xq * np.r_[
            np.ones(2 * dsub), np.zeros(FORCED_D - 2 * dsub)][None, :]
    cj = np.arange(FORCED_CLUSTER)
    for i in range(FORCED_NQ):
        slots = torch.randperm(lmax, device=DEVICE,
                               generator=g)[:FORCED_CLUSTER]
        codes = np.tile(f[i], (FORCED_CLUSTER, 1))
        codes[:, 0], codes[:, 1] = cj % ksub, cj // ksub
        lists[i, slots] = torch.from_numpy(codes.astype(np.uint8)).to(DEVICE)
    counts = torch.full((nlist,), lmax, dtype=torch.int32, device=DEVICE)
    row_pos = live_row_pos(counts, lmax)
    cb_t, cents_t, xq_t = dev(cb), dev(cents), dev(xq)
    others = torch.rand(FORCED_NQ, nlist - FORCED_NQ, device=DEVICE,
                        generator=g).argsort(1)[:, :nprobe - 1]
    probe = torch.cat([torch.arange(FORCED_NQ, device=DEVICE)[:, None],
                       FORCED_NQ + others], 1).to(torch.int32).contiguous()
    rt = k8.pq_row_terms(lists, counts, cents_t, cb_t, "pq")
    args = [lists, counts, row_pos, cb_t, cents_t, probe, xq_t, None]
    kw = dict(metric=metric, codec="pq", row_terms=rt)
    err, unproven = k8_error(args, kw, K)
    ref_s, _ = k8.ivf_pq_list_search_reference(*args, k=FORCED_CLUSTER, **kw)
    cn = float((cents_t * cents_t).sum(1).max())
    rho = float(k8.residual_bound(k8.codebook_norms(cb_t), "pq"))
    e = k8.error_bound((xq_t * xq_t).sum(1), cn, rho, FORCED_D, m, metric)
    tol = (REL_TOL * float((xq_t * xq_t).sum(1).max()) if metric == "L2"
           else REL_TOL * 10.0)
    pool = K + k8.margin(K)
    within = forced_check(f"K8 {metric}", ref_s, K, pool, e, tol)
    check(unproven == FORCED_NQ, f"K8 {metric}: {unproven} of {FORCED_NQ} "
          f"forced queries counted unproven")
    log(f"forced margin K8 PQ{m} {metric} d={FORCED_D} k={K}: {unproven} of "
        f"{FORCED_NQ} queries unproven, at least {within} rows within 2E of "
        f"the k-th score (pool {pool}), result agrees with the plain version "
        f"(max abs error {err:.3g})")
    return err


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
    for metric in ("L2", "INNER_PRODUCT"):
        err = max(err, forced_pq_case(metric))
    torch.cuda.empty_cache()
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
    from duckdb_faiss_ext_tpu_torch.utils.transfer import fetch_results
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

#: phase 17: the standalone SQ codecs over phase 5's corpus; then SQ8 inner
#: product over the first SQ_WIDE_N rows of phase 10's 1536-d generator
SQ_STANDALONE = ("SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16")
SQ_WIDE_N = 4 * SQ_CHUNK
#: phase 18: the filtered bench's pass rates, the TREC run's depth
FILTER_PASSRATES, TREC_K = (0.5, 0.1, 0.01), 100
#: phase 17: rows K1 picks for the int8 path's fp64 reference
SQ_EXACT_WIDTH = 4 * K
#: phase 19: the port bench's time limit, seconds
BENCH_TIMEOUT = 300


def walls_ms(fn, reps=5):
    """Median host-clock ms of ``fn`` (a public-API call that returns its
    results on the host)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls)


def decoded_k1(decoded, n, queries, metric, mask=None, width=K + 1):
    """K1 over a decoded corpus on the card, ``width`` wide: (distances,
    labels) as numpy (labels are rows)."""
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores

    xq = torch.from_numpy(queries).to(DEVICE)
    d, p = finalize_scores(*ft.flat_topk(decoded, n, xq, width, metric, mask),
                           metric)
    return d.cpu().numpy(), p.cpu().numpy().astype(np.int64)


def rows_f64(codes, vmin, scale, codec, queries, labels, metric):
    """fp64 distances (L2 in difference form) of each query's labelled rows,
    decoded from the codes on the card; labels -1 give NaN."""
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_decode

    rows = torch.from_numpy(np.maximum(labels, 0)).to(DEVICE).reshape(-1)
    x = sq_decode(codes[rows], vmin, scale, codec).double().reshape(
        *labels.shape, -1)
    q = torch.from_numpy(queries).to(DEVICE).double()[:, None, :]
    s = ((x - q) ** 2).sum(-1) if metric == "L2" else (x * q).sum(-1)
    return np.where(labels >= 0, s.cpu().numpy(), np.nan)


def exact_ref(state, codec, queries, wide, metric):
    """K1's ``SQ_EXACT_WIDTH``-wide result over the decoded corpus rescored
    in fp64 from the codes, re-sorted and cut to K + 1: (distances, labels,
    K1's max abs error against the fp64 distances of its own rows)."""
    dist, labels = wide
    s = rows_f64(*state, codec, queries, labels, metric)
    finite = labels >= 0
    k1_err = float(np.abs(np.where(finite, dist - s, 0)).max())
    key = np.where(finite, s if metric == "L2" else -s, np.inf)
    order = np.argsort(key, axis=1, kind="stable")[:, :K + 1]
    s = np.where(finite, s, np.inf if metric == "L2" else -np.inf)
    return (np.take_along_axis(s, order, 1).astype(np.float32),
            np.take_along_axis(labels, order, 1), k1_err)


def sq_standalone_leg(dt, cat, name, n, metric, batches, smi, db=None):
    """One standalone SQ index through the public API on the card at every
    batch (and filtered 'id%2==0' when ``db`` is given), with wall times.
    The parity path computes as K1 does (fp32, L2 in expansion form) and is
    held against K1 over the decoded corpus (the plain version of the
    decode path).  The int8 path (fast mode, quantized codecs) rescores in
    fp32 difference form and is held against the exact reference: K1's
    best ``SQ_EXACT_WIDTH`` rows rescored in fp64 from the codes (L2 in
    difference form).  Both at ``compare_results``' tolerance; K1's own
    error against fp64 is printed beside the paths'.  Returns the max
    distance error."""
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_decode

    index = cat.get(name).index
    check(index.device.type == DEVICE, f"{name}: index not on the card")
    state = index._device_state()
    decoded = sq_decode(state[0][:n], *state[1:], index.codec).contiguous()
    even = (torch.arange(n, device=DEVICE) % 2 == 0).to(torch.int8)
    queries = dict(batches)
    masks = dict.fromkeys(queries)
    if db is not None:
        queries["filter"], masks["filter"] = batches[0][1], even
    ft.LAUNCHES = 0
    wide = {b: decoded_k1(decoded, n, xq, metric, masks[b], SQ_EXACT_WIDTH)
            for b, xq in queries.items()}
    check(ft.LAUNCHES == len(wide), f"{name}: K1 over the decoded corpus "
          f"launched {ft.LAUNCHES} times, not {len(wide)}")
    del decoded
    refs = {"parity": {b: (d[:, :K + 1], p[:, :K + 1])
                       for b, (d, p) in wide.items()}, "fast": {}}
    k1_err = {}
    for b, w in wide.items():
        *refs["fast"][b], k1_err[b] = exact_ref(state, index.codec,
                                                queries[b], w, metric)
    err, times, errs = 0.0, [], []
    modes = ("parity", "fast") if index.codec.startswith("sq") else (
        "parity",)
    for mode in modes:
        dt.set_precision(mode)
        check(index.int8_serves() == (mode == "fast"), f"{name}: {mode} "
              f"path not taken")
        for b, xq in batches:
            res = dt.faiss_search(name, K, xq, catalog=cat)
            e = compare_results(f"{name} {mode} {b}", res, *refs[mode][b],
                                metric != "L2")
            errs.append(f"{mode} {b} {e:.3g}")
            err = max(err, e)
            ms = walls_ms(lambda: dt.faiss_search(name, K, xq, catalog=cat),
                          reps=3)
            times.append(f"{mode} {b} {ms:.3f}")
        if db is not None:
            res = dt.faiss_search_filter(name, K, batches[0][1], "id%2==0",
                                         "id", "base", catalog=cat,
                                         database=db)
            check((res["label"] % 2 == 0).all(), f"{name}: odd label")
            e = compare_results(f"{name} {mode} filter", res,
                                *refs[mode]["filter"], metric != "L2")
            errs.append(f"{mode} filter {e:.3g}")
            err = max(err, e)
    dt.set_precision("parity")
    log(f"sq standalone {name} {n}x{index.d} {metric}: parity path agrees "
        f"with K1 over the decoded corpus"
        f"{', int8 path with its rows rescored in fp64' * (len(modes) > 1)}"
        f" at {', '.join(queries)}; max distance error: {'; '.join(errs)}; "
        f"K1's fp32 against fp64: "
        f"{'; '.join(f'{b} {e:.3g}' for b, e in k1_err.items())}; "
        f"faiss_search wall ms (median): {'; '.join(times)}; card peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    return err


def phase_sq_standalone(smi, data):
    """Standalone SQ8 / SQ4 / SQ6 / SQfp16 / SQbf16 L2 over phase 5's 1M x
    128 corpus at b48 and b1024 (and filtered), a save → load round trip
    on the card, then SQ8 inner product over 1M x 1536 (1.5 GB of codes)."""
    import tempfile

    import duckdb_faiss_ext_tpu_torch as dt

    xb, ids = data["xb"], data["ids"]
    db = dt.Database()
    db.register("base", {"id": ids})
    batches = (("b48", data["b48"]), ("b1024", data["b1024"]))
    err = 0.0
    for codec in SQ_STANDALONE:
        cat = dt.Catalog()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dt.faiss_create(codec, D, codec, metric_type="L2", catalog=cat)
        dt.faiss_add(xb, codec, catalog=cat)
        log(f"sq standalone {codec}: create + train + add {N} rows "
            f"{time.perf_counter() - t0:.2f} s, codes "
            f"{cat.get(codec).index._codes.nbytes / 2**20:.1f} MiB")
        err = max(err, sq_standalone_leg(dt, cat, codec, N, "L2", batches,
                                         smi, db))
        if codec in ("SQ8", "SQbf16"):
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "sq.dfx")
                dt.faiss_save(codec, path, catalog=cat)
                dt.faiss_load("reloaded", path, catalog=cat)
            a = dt.faiss_search(codec, K, data["b48"], catalog=cat)
            b = dt.faiss_search("reloaded", K, data["b48"], catalog=cat)
            check(np.array_equal(a, b), f"{codec}: save → load differs")
            check(cat.get("reloaded").index.device.type == DEVICE,
                  f"{codec}: reloaded index not on the card")
            log(f"sq standalone {codec}: save → load on the card, b48 "
                f"results equal")
        if codec == "SQ8":
            data["sq8_cat"] = cat   # phase 24's standalone SQ8
        del cat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    corpus = marco_corpus()
    xq = corpus.queries(BATCH + BIG_BATCH)
    cat = dt.Catalog()
    t0 = time.perf_counter()
    dt.faiss_create("wide", SQ_D, "SQ8", metric_type="INNER_PRODUCT",
                    catalog=cat)
    dt.faiss_manual_train(corpus.chunk(0).cpu().numpy(), "wide", catalog=cat)
    for i, rows in corpus_chunks(SQ_WIDE_N):
        dt.faiss_add(corpus.chunk(i, rows).cpu().numpy(), "wide",
                     catalog=cat)
    log(f"sq standalone SQ8 {SQ_WIDE_N}x{SQ_D} IP: train + add "
        f"{time.perf_counter() - t0:.2f} s, codes "
        f"{cat.get('wide').index._codes.nbytes / 1e9:.2f} GB")
    err = max(err, sq_standalone_leg(
        dt, cat, "wide", SQ_WIDE_N, "INNER_PRODUCT",
        (("b48", xq[:BATCH]), ("b1024", xq[BATCH:])), smi))
    del cat
    torch.cuda.empty_cache()
    return err


def phase_sql_harness(smi, data, ivf):
    """The SQL shell over the golden corpus, the filtered bench over 1M x
    128 IDMap,Flat, autotune on phase 7's IVF4096 index and a TREC run of
    Flat, all on the card."""
    import tempfile

    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch import harness
    from duckdb_faiss_ext_tpu_torch.harness import trec
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.sql.dispatch import connect

    # The golden corpus through sql.dispatch: the statements phase 4 holds
    # through the API (test/sql/faiss.test, faiss3.test of the reference).
    raw = {name: np.loadtxt(os.path.join(HERE, "tests", "data", name),
                            delimiter=",", dtype=np.float64)
           for name in ("training.csv", "queries.csv")}
    con = connect(catalog=dt.Catalog(), database=dt.Database())
    gids = raw["training.csv"][:, 0].astype(np.int64)
    con.register("training", {"id": gids, "column0": gids,
                              "data": raw["training.csv"][:, 1:].astype(
                                  np.float32)})
    con.register("queries", {"data": raw["queries.csv"][:, 1:].astype(
        np.float32)})
    for stmt in ("CALL faiss_create('flat8', 8, 'Flat')",
                 "CALL faiss_add((SELECT data FROM training), 'flat8')",
                 "CALL faiss_create('flat82', 8, 'IDMap,Flat')",
                 "CALL faiss_add((SELECT id, data FROM training), 'flat82')"):
        check(con.execute(stmt) is None, f"sql: {stmt}")
    check(catalog_device(con.catalog, "flat82") == DEVICE, "sql: index not "
          "on the card")
    rows = con.execute("SELECT UNNEST(faiss_search('flat8', 2, data)) FROM "
                       "queries")
    np.testing.assert_allclose([r["distance"] for r in rows],
                               GOLDEN_FLAT_DISTANCES, rtol=2e-6)
    rows = con.execute("SELECT UNNEST(faiss_search('flat82', 2, data)) FROM "
                       "queries")
    check([r["label"] for r in rows] == [x for pair in GOLDEN_LABELS
                                         for x in pair], "sql: labels")
    gl, gd = zip(*GOLDEN_FILTERED)
    for fn in ("faiss_search_filter", "faiss_search_filter_set"):
        rows = con.execute(f"SELECT UNNEST({fn}('flat82', 2, data, "
                           f"'column0>100', 'column0', 'training')) FROM "
                           f"queries")
        check([r["label"] for r in rows] == list(gl), f"sql {fn}: labels")
        np.testing.assert_allclose([r["distance"] for r in rows], gd,
                                   rtol=1e-4)
    log("sql shell: the golden corpus through sql.dispatch.connect() gives "
        "the reference's distances, labels and filtered rows on the card")

    # The filtered bench over the 1M x 128 IDMap,Flat.
    xb, ids = data["xb"], data["ids"]
    cat = dt.Catalog()
    db = dt.Database()
    db.register("base", {"id": ids})
    dt.faiss_create("sift", D, "IDMap,Flat", metric_type="L2", catalog=cat)
    dt.faiss_add((ids, xb), "sift", catalog=cat)
    iters = 3
    ft.LAUNCHES = 0
    results = harness.run_filtered_bench(
        "sift", data["b48"], "base", "id", passrates=FILTER_PASSRATES,
        want=K, catalog=cat, database=db, iters=iters)
    launches = ft.LAUNCHES
    # Per pass rate, each strategy runs once to warm up and ``iters`` times
    # timed: the bitmap and set selectors through K1 with a mask, the
    # post-filter through K1 where its k' is within K1's limit.
    expected = sum((iters + 1) * (2 + (harness.required_k(K, p) <= ft.MAX_K))
                   for p in FILTER_PASSRATES)
    check(launches == expected, f"filtered bench launched K1 {launches} "
          f"times, not {expected}")
    for r in results:
        log(f"filtered bench {N}x{D} pass rate {r.passrate}: k' "
            f"{r.required_k}; qps post-filter {r.qps_post:.1f}, bitmap "
            f"selector {r.qps_sel:.1f}, id-set selector {r.qps_set:.1f} "
            f"(b{BATCH}, host clock) [{smi}]")
    log(f"filtered bench: {launches} K1 launches")

    # TREC: a run file of the Flat index scored against exact qrels.
    qids = list(range(BATCH))
    qrels = trec.make_synthetic_qrels(xb, data["b48"], qids, metric="L2")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flat.run")
        trec.write_trec_run(path, "sift", qids, data["b48"], k=TREC_K,
                            catalog=cat)
        scores = trec.score_trec_run(path, qrels, recall_k=TREC_K)
    check(scores[f"recall@{TREC_K}"] == 1.0, f"trec: {scores}")
    log(f"trec run of Flat ({BATCH} queries, k={TREC_K}): {scores}")
    del cat

    # Autotune on phase 7's IVF4096 index (b48: the fused K6 every search).
    k6.LAUNCHES = k6.TOPK_LAUNCHES = k7.LAUNCHES = k7.TOPK_LAUNCHES = 0
    repeat = 3
    tune = harness.autotune_index("ivf", data["b48"], k=K, target_recall=0.95,
                                  catalog=ivf["cat"], repeat=repeat)
    # Each search launches the fused K6 once a query block (a b48 batch at
    # a high nprobe runs in blocks, IVFServe.query_block); the ground truth
    # searches at nprobe = nlist.
    index = ivf["cat"].get("ivf").index.inner
    lmax = index._build_device_layout().payload.shape[1]

    def blocks(nprobe):
        return 64 // index.query_block(64, min(nprobe, index.nlist), lmax)

    searches = 1 + len(tune.points) * (1 + repeat)
    expected = blocks(index.nlist) + sum(
        (1 + repeat) * blocks(int(p.params["nprobe"])) for p in tune.points)
    check((k6.TOPK_LAUNCHES, k6.LAUNCHES, k7.TOPK_LAUNCHES, k7.LAUNCHES)
          == (expected, 0, 0, 0), f"autotune launched the fused K6 "
          f"{k6.TOPK_LAUNCHES} times, not {expected}")
    check(tune.points[-1].recall == 1.0 and tune.best is not None,
          "autotune: exhaustive point")
    log(f"autotune IVF4096 {N}x{D} b{BATCH} ({searches} searches, "
        f"{expected} fused K6 launches) [{smi}]:\n{tune}")


def phase_port_bench(ivf_recall):
    """``python3 -m duckdb_faiss_ext_tpu_torch.bench`` in a subprocess under
    a time limit: one JSON line with bench.py's keys."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "duckdb_faiss_ext_tpu_torch.bench"],
                         capture_output=True, text=True, cwd=HERE,
                         timeout=BENCH_TIMEOUT)
    for line in out.stderr.strip().splitlines()[-12:]:
        log(f"port bench: {line}")
    check(out.returncode == 0, f"port bench exited {out.returncode}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 1, f"port bench printed {len(lines)} lines")
    line = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "pipelined_qps",
                "ivf_qps", "ivf_recall", "cpu_qps"):
        check(key in line, f"port bench line lacks {key}")
    log(f"port bench ({time.perf_counter() - t0:.1f} s): {lines[0]}")
    log(f"port bench ivf_recall {line['ivf_recall']:.4f} beside phase 7's "
        f"b48 recall@10 {ivf_recall:.4f}")
    return line



#: phase 20: the compressed pipeline of examples/compression_pipeline.py:42
#: at phase 12's IVF4096 size, reranked over k_factor x k candidates
OPQ_FACTORY, REFINE_KF = "OPQ16,IVF4096,PQ16,RFlat", 8
#: phase 21: tools/marco_refine.py's refine tier at phase 10's row cut
MARCO_REFINE_KF = 4
#: phase 22: 16,384 IMI cells probed 256 at a time (about the rows IVF4096
#: probes at 64, BASELINE.md:69), lists capped at 1024 slots (the full
#: layout of the skewed cells would be 34 GB); SOAR over phase 7's centroids
IMI_FACTORY, IMI_NPROBE, IMI_LMAX_CAP = "IMI2x7,Flat", 256, 1024
SOAR_LAMBDA, SOAR_NPROBES = "1.0", (16, 64)
#: phase 23: 128-bit LSH with a rotation and trained thresholds, and ITQ to
#: 64 bits
LSH_FACTORIES = ("LSHrt", "ITQ64,LSH")


@contextlib.contextmanager
def plain_list_kernels():
    """Run the IVF,Flat path with the plain versions of K6 and K7 / K10 (the
    fused searches) in place of their wrappers (same inputs)."""
    from duckdb_faiss_ext_tpu_torch.models import ivf_serve
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    saved = (ivf_serve.ivf_list_search, ivf_serve.ivf_pairs_search)
    ivf_serve.ivf_list_search = k6.ivf_list_search_reference

    def pairs_plain(*args, mega=False, **kw):
        return k7.ivf_pairs_search_reference(*args, **kw)

    ivf_serve.ivf_pairs_search = pairs_plain
    try:
        yield
    finally:
        ivf_serve.ivf_list_search, ivf_serve.ivf_pairs_search = saved


@contextlib.contextmanager
def plain_k1():
    """Run Flat searches with K1's plain version in place of its wrapper."""
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores

    saved = ft.kernel_flat_search

    def plain(xb, nvalid, xq, k, metric, mask=None):
        return finalize_scores(*ft.flat_topk_reference(xb, nvalid, xq, k,
                                                       metric, mask), metric)

    ft.kernel_flat_search = plain
    try:
        yield
    finally:
        ft.kernel_flat_search = saved


def wider(params, k_factor):
    """``params`` for the plain path one wider (k + 1) at the same k_base =
    round(k·k_factor) of the refine wrapper."""
    return dict(params, k_factor=repr(k_factor * K / (K + 1)))


def soar_lmax_cap(counts, n_rows):
    """The smallest list cap from 1024 up (powers of two) whose overflow
    rows are at most a tenth of the rows: SOAR's second lists are skewed,
    and the full padded layout of phase 22's index is 38 GiB (its longest
    list holds 19,184 rows)."""
    cap = 1024
    while int(np.maximum(counts - cap, 0).sum()) > 0.1 * n_rows:
        cap *= 2
    return cap


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2**30


def expected_list_launches(index, nq, nprobe, lmax):
    """(per-query launches, pair-tile launches) of one search of nq queries:
    one a query block, each block sent to K6 or K7 by the static rule."""
    from duckdb_faiss_ext_tpu_torch.utils.config import config, next_pow2

    nq_pad = max(config.min_query_bucket, next_pow2(nq))
    blk = index.query_block(nq_pad, nprobe, lmax)
    n = nq_pad // blk
    return (0, n) if index.pairs_wanted(blk, lmax) else (n, 0)


def phase_refine_pipeline(smi, data, exact):
    """Phase 20: OPQ16,IVF4096,PQ16,RFlat L2 over phase 7's corpus, then
    PCA64,Flat L2 and L2norm,Flat IP."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores

    xb = data["xb"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cat = dt.Catalog()
    params = {"nprobe": str(IVF_NPROBE), "k_factor": str(REFINE_KF)}
    t0 = time.perf_counter()
    dt.faiss_create("opq", D, OPQ_FACTORY, metric_type="L2", catalog=cat)
    dt.faiss_manual_train(xb[:IVF_TRAIN], "opq", catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add(xb, "opq", catalog=cat)
    t_add = time.perf_counter() - t0
    rf = cat.get("opq").index
    ivf = rf.base.inner
    t0 = time.perf_counter()
    lay = ivf._build_device_layout()
    t_layout = time.perf_counter() - t0
    check(ivf.device.type == DEVICE and rf.refine.device.type == DEVICE,
          "refine pipeline not on the card")
    log(f"refine {OPQ_FACTORY} {N}x{D} L2: OPQ + IVF-PQ train "
        f"{t_train:.2f} s, add {t_add:.2f} s (codes "
        f"{ivf._codes.nbytes / 1e6:.0f} MB, raw store "
        f"{rf.refine.vectors().nbytes / 1e6:.0f} MB), layout build+upload "
        f"{t_layout:.2f} s; lmax {lay.payload.shape[1]}")
    k8.LAUNCHES = 0
    out, paths = {}, {}
    for b in ("b48", "b1024"):
        out[b] = dt.faiss_search("opq", K, data[b], params, catalog=cat)
        paths[b] = ivf._last_scan_path
    check(k8.LAUNCHES == 2, f"refine pipeline launched K8 {k8.LAUNCHES} "
          f"times, not 2")
    check(set(paths.values()) == {"per-query"}, f"base off K8: {paths}")
    with plain_k8():
        ref = {b: dt.faiss_search("opq", K + 1, data[b],
                                  wider(params, REFINE_KF), catalog=cat)
               for b in out}
    check(k8.LAUNCHES == 2, "the plain path launched K8")
    err, parts = 0.0, []
    for b, res in out.items():
        check(np.isfinite(res["distance"]).all(), f"refine {b}: non-finite")
        err = max(err, compare_results(f"refine {b}", res, ref[b]["distance"],
                                       ref[b]["label"], False))
        parts.append(
            f"{b}: base path {paths[b]} (k_base {REFINE_KF * K}), recall@10 "
            f"vs exact Flat {recall(res['label'], exact[b]):.4f}, "
            f"faiss_search wall "
            f"{walls_ms(lambda: dt.faiss_search('opq', K, data[b], params, catalog=cat)):.3f} ms")  # noqa: E501
    log(f"refine {OPQ_FACTORY} nprobe {IVF_NPROBE} k_factor {REFINE_KF}: "
        f"agrees with the plain K8 path (max distance error {err:.3g}); "
        f"{'; '.join(parts)}; K8 launches 2; card peak {peak_gib():.2f} GiB "
        f"[{smi}]")
    del cat, rf, ivf, lay
    for desc, metric in (("PCA64,Flat", "L2"),
                         ("L2norm,Flat", "INNER_PRODUCT")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cat = dt.Catalog()
        t0 = time.perf_counter()
        dt.faiss_create("t", D, desc, metric_type=metric, catalog=cat)
        dt.faiss_add(xb, "t", catalog=cat)
        t_add = time.perf_counter() - t0
        pre = cat.get("t").index
        corpus = pre.inner.device_vectors()
        ft.LAUNCHES = 0
        res = {b: dt.faiss_search("t", K, data[b], catalog=cat)
               for b in ("b48", "b1024")}
        check(ft.LAUNCHES == 2, f"{desc}: K1 launched {ft.LAUNCHES} times, "
              f"not 2")
        parts = []
        for b, r in res.items():
            xt = torch.from_numpy(pre.apply_chain(data[b])).to(DEVICE)
            rd, rp = finalize_scores(*ft.flat_topk_reference(
                corpus, N, xt, K + 1, metric), metric)
            e = compare_results(f"{desc} {b}", r, rd.cpu().numpy(),
                                rp.cpu().numpy().astype(np.int64),
                                metric != "L2")
            rec = recall(r["label"], rp[:, :K].cpu().numpy())
            check(rec == 1.0, f"{desc} {b}: recall {rec} in transform space")
            parts.append(f"{b} max distance error {e:.3g}, faiss_search wall "
                         f"{walls_ms(lambda: dt.faiss_search('t', K, data[b], catalog=cat)):.3f} ms")  # noqa: E501
        log(f"transform {desc} {N}x{D} {metric}: train + add {t_add:.2f} s; "
            f"K1 launches 2, recall@10 1.0 against K1's plain version on the "
            f"transformed corpus; {'; '.join(parts)}; card peak "
            f"{peak_gib():.2f} GiB [{smi}]")
        del cat, pre, corpus


def phase_marco_refine(smi, sq):
    """Phase 21: IVF4096,SQ8,RFlat IP over phase 10's 2,097,152 x 1536
    corpus, its base loaded with phase 10's trained centroids and SQ
    ranges, in fast mode."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops import sq_spill as k5

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    corpus = marco_corpus()
    xq_all = corpus.queries(BATCH * N_BATCHES + BIG_BATCH)
    queries = {"b48": xq_all[:BATCH], "b1024": xq_all[-BIG_BATCH:]}
    cat = dt.Catalog()
    params = {"nprobe": str(SQ_NPROBE), "k_factor": str(MARCO_REFINE_KF)}
    dt.faiss_create("mrf", SQ_D, f"IVF{SQ_NLIST},SQ8,RFlat",
                    metric_type="INNER_PRODUCT", catalog=cat)
    rf = cat.get("mrf").index
    base = rf.base
    base.LAYOUT_BUDGET_BYTES = SQ_NLIST * SQ_LMAX_CAP * SQ_D
    base.load_state(dict(
        sq["state"], xb=np.empty((0, SQ_D), np.float32),
        ids=np.empty((0,), np.int64), assign=np.empty((0,), np.int32),
        codes=np.empty((0, SQ_D), np.uint8)))
    check(base.is_trained, "marco refine: base not trained by load_state")
    t0 = time.perf_counter()
    rows = np.empty((SQ_N, SQ_D), np.float32)
    for i, n in corpus_chunks(SQ_N):
        rows[i * SQ_CHUNK:i * SQ_CHUNK + n] = corpus.chunk(i, n).cpu().numpy()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add(rows, "mrf", catalog=cat)
    t_add = time.perf_counter() - t0
    del rows
    dt.set_precision("fast")
    t0 = time.perf_counter()
    lay = base._build_device_layout()
    rf.refine.device_vectors()
    t_layout = time.perf_counter() - t0
    check(base._layout_plan() == ("spill", SQ_LMAX_CAP), "no capped plan")
    log(f"marco refine: corpus to the host {t_make:.2f} s, add {t_add:.2f} s "
        f"(codes {base._codes.nbytes / 1e9:.2f} GB, raw store "
        f"{rf.refine.vectors().nbytes / 1e9:.2f} GB), layout + raw store "
        f"upload {t_layout:.2f} s; spill {base._spill.n} rows")
    k2.LAUNCHES = k2.TOPK_LAUNCHES = k3.LAUNCHES = k5.LAUNCHES = 0
    out, paths = {}, {}
    for b, xq in queries.items():
        out[b] = dt.faiss_search("mrf", K, xq, params, catalog=cat)
        paths[b] = base._last_scan_path
    launches = (k2.TOPK_LAUNCHES, k3.LAUNCHES, k5.LAUNCHES)
    lmax = lay.payload.shape[1]
    want = (int(not base.pairs_wanted(64, lmax))
            + int(not base.pairs_wanted(BIG_BATCH, lmax)),
            int(base.pairs_wanted(64, lmax))
            + int(base.pairs_wanted(BIG_BATCH, lmax)), 2)
    check(launches == want and k2.LAUNCHES == 0, f"marco refine launched "
          f"(K2 fused, K3, K5) {launches} times, not {want}")
    check(paths == {"b48": "per-query", "b1024": "pairs-sq8"},
          f"marco refine base paths {paths}")
    with plain_sq_kernels():
        ref = {b: dt.faiss_search("mrf", K + 1, xq,
                                  wider(params, MARCO_REFINE_KF), catalog=cat)
               for b, xq in queries.items()}
    err, parts = 0.0, []
    for b, res in out.items():
        check(np.isfinite(res["distance"]).all(), f"marco refine {b}: "
              f"non-finite")
        err = max(err, compare_results(f"marco refine {b}", res,
                                       ref[b]["distance"], ref[b]["label"],
                                       True))
        walls = walls_ms(lambda: dt.faiss_search("mrf", K, queries[b], params,
                                                 catalog=cat), reps=3)
        parts.append(f"{b}: base path {paths[b]} (k_base "
                     f"{MARCO_REFINE_KF * K}), recall@10 vs exact fp32 "
                     f"{recall(res['label'], sq['exact'][b]):.4f} (phase 10 "
                     f"without refine {sq['recall'][b]:.4f}), faiss_search "
                     f"wall {walls:.3f} ms")
    dt.set_precision("parity")
    log(f"marco refine IVF{SQ_NLIST},SQ8,RFlat {SQ_N}x{SQ_D} IP nprobe "
        f"{SQ_NPROBE} k_factor {MARCO_REFINE_KF} fast mode: (K2 fused, K3, "
        f"K5) launches {launches}; agrees with the plain K2 / K3 / K5 path "
        f"(max distance error {err:.3g}); {'; '.join(parts)}; card peak "
        f"{peak_gib():.2f} GiB [{smi}]")


def list_path_check(tag, dt, cat, name, index, queries, params, exact,
                    similarity=False):
    """The IVF,Flat searches of ``queries`` through the public API: K6 / K7
    launch counts as the static rule and the query blocks predict, results
    held against the plain K6 / K7 path one wider (``compare_results``; with
    SOAR the plain path fetches 2(k + 1) candidates, whose first k distinct
    rows are the kernel path's 2k candidates' when they are apart), no
    label repeated within a query,
    recall@10 against exact Flat and wall times.  Returns (recalls, max
    distance error, log text)."""
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7

    lmax = index._build_device_layout().payload.shape[1]
    nprobe = int(params["nprobe"])
    k6.LAUNCHES = k6.TOPK_LAUNCHES = k7.LAUNCHES = k7.TOPK_LAUNCHES = 0
    out = {b: dt.faiss_search(name, K, xq, params, catalog=cat)
           for b, xq in queries.items()}
    want = tuple(map(sum, zip(*(expected_list_launches(index, xq.shape[0],
                                                       nprobe, lmax)
                                for xq in queries.values()))))
    got = (k6.TOPK_LAUNCHES, k7.TOPK_LAUNCHES)
    check(got == want and k6.LAUNCHES == k7.LAUNCHES == 0, f"{tag}: (K6, K7) "
          f"fused launches {got}, not {want}, raw {k6.LAUNCHES}, "
          f"{k7.LAUNCHES}")
    with plain_list_kernels():
        ref = {b: dt.faiss_search(name, K + 1, xq, params, catalog=cat)
               for b, xq in queries.items()}
    err, recs, parts = 0.0, {}, []
    for b, res in out.items():
        check(np.isfinite(res["distance"]).all(), f"{tag} {b}: non-finite")
        err = max(err, compare_results(f"{tag} {b}", res, ref[b]["distance"],
                                       ref[b]["label"], similarity))
        for row in res["label"]:
            check(len(set(row.tolist())) == len(row), f"{tag} {b}: a label "
                  f"repeats within a query")
        recs[b] = recall(res["label"], exact[b])
        parts.append(f"{b} recall@10 {recs[b]:.4f}, faiss_search wall "
                     f"{walls_ms(lambda: dt.faiss_search(name, K, queries[b], params, catalog=cat), reps=3):.3f} ms")  # noqa: E501
    return recs, err, (f"(K6, K7) fused launches {got}; agrees with the plain "
                       f"K6 / K7 path (max distance error {err:.3g}); "
                       f"{'; '.join(parts)}")


def phase_imi_soar(smi, data, exact, ivf):
    """Phase 22: IMI2x7,Flat L2 and IVF4096,Flat with SOAR over phase 7's
    corpus (SOAR on phase 7's trained centroids).  Returns the SOAR
    catalog."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.models.ivf_layout import choose_lmax
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk

    xb = data["xb"]
    queries = {b: data[b] for b in ("b48", "b1024")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cat = dt.Catalog()
    t0 = time.perf_counter()
    dt.faiss_create("imi", D, IMI_FACTORY, metric_type="L2", catalog=cat)
    index = cat.get("imi").index
    index.LAYOUT_BUDGET_BYTES = index.nlist * IMI_LMAX_CAP * D * 4
    dt.faiss_manual_train(xb[:IVF_TRAIN], "imi", catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add(xb, "imi", catalog=cat)
    t_add = time.perf_counter() - t0
    t0 = time.perf_counter()
    lay = index._build_device_layout()
    t_layout = time.perf_counter() - t0
    counts = index._counts()
    spill = index._spill
    check(index._layout_plan() == ("spill", IMI_LMAX_CAP), "imi: no capped "
          f"plan ({index._layout_plan()})")
    probe = coarse_topk(torch.from_numpy(data["b48"]).to(DEVICE),
                        lay.centroids, IMI_NPROBE, "L2")
    _, _, rows_all = probed_rows(lay.counts, probe)
    log(f"imi {IMI_FACTORY} {N}x{D} L2: train {t_train:.2f} s (two "
        f"{1 << index.imi_nbits}-centroid k-means on the halves), add {t_add:.2f} s, layout "
        f"build+upload {t_layout:.2f} s; {index.nlist} cells, "
        f"{int((counts > 0).sum())} non-empty, longest {int(counts.max())}, "
        f"full lmax would be {choose_lmax(int(counts.max()))}; capped lmax "
        f"{lay.payload.shape[1]}, padded layout "
        f"{lay.payload.numel() * 4 / 2**30:.2f} GiB, spill "
        f"{spill.n if spill else 0} rows; b48 probes {rows_all / BATCH:.0f} "
        f"layout rows a query at nprobe {IMI_NPROBE}")
    _, err, text = list_path_check(f"imi nprobe {IMI_NPROBE}", dt, cat, "imi",
                                   index, queries,
                                   {"nprobe": str(IMI_NPROBE)}, exact)
    log(f"imi {IMI_FACTORY} nprobe {IMI_NPROBE}: {text}; card peak "
        f"{peak_gib():.2f} GiB [{smi}]")
    del cat, index, lay, spill
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    ref_ivf = ivf["cat"].get("ivf").index.inner
    scat = dt.Catalog()
    dt.faiss_create_params("soar", D, f"IVF{ref_ivf.nlist},Flat",
                           {"soar_lambda": SOAR_LAMBDA}, metric_type="L2",
                           catalog=scat)
    soar = scat.get("soar").index
    soar.load_state({"xb": np.empty((0, D), np.float32),
                     "ids": np.empty((0,), np.int64),
                     "assign": np.empty((0,), np.int32),
                     "centroids": ref_ivf._centroids})
    t0 = time.perf_counter()
    dt.faiss_add(xb, "soar", catalog=scat)
    t_add = time.perf_counter() - t0
    counts = soar._counts()
    cap = soar_lmax_cap(counts, soar._nstored)
    soar.LAYOUT_BUDGET_BYTES = soar.nlist * cap * D * 4
    t0 = time.perf_counter()
    lay = soar._build_device_layout()
    t_layout = time.perf_counter() - t0
    check(soar.ntotal == N and soar._nstored == 2 * N, "soar: row counts")
    check(soar._layout_plan()[1] in (None, cap), "soar: layout plan")
    moved = float(np.mean(soar._assign[N:] != soar._assign[:N]))
    check(moved == 1.0, "soar: a second list equals the first")
    log(f"soar IVF{soar.nlist},Flat lambda {SOAR_LAMBDA} {N}x{D} L2 on phase "
        f"7's centroids: add {t_add:.2f} s (both assignments), layout "
        f"build+upload {t_layout:.2f} s; {soar._nstored} storage rows "
        f"({soar._xb.nbytes / 2**30:.2f} GiB), longest list "
        f"{int(counts.max())} (full lmax {choose_lmax(int(counts.max()))}), "
        f"lmax {lay.payload.shape[1]}, padded layout "
        f"{lay.payload.numel() * 4 / 2**30:.2f} GiB, spill "
        f"{soar._spill.n if soar._spill else 0} rows")
    for nprobe in SOAR_NPROBES:
        params = {"nprobe": str(nprobe)}
        recs, err, text = list_path_check(f"soar nprobe {nprobe}", dt, scat,
                                          "soar", soar, queries, params,
                                          exact)
        plain = {b: recall(dt.faiss_search("ivf", K, data[b], params,
                                           catalog=ivf["cat"])["label"],
                           exact[b]) for b in queries}
        log(f"soar nprobe {nprobe}: {text}; phase 7's IVF{ref_ivf.nlist} at "
            f"the same nprobe: recall@10 b48 {plain['b48']:.4f}, b1024 "
            f"{plain['b1024']:.4f}; card peak {peak_gib():.2f} GiB [{smi}]")
    return scat


def pack_words(signs):
    """(n, nbits) ±1 int8 codes on the card → (n, ceil(nbits / 32)) int64
    words of 32 bits each."""
    n, nbits = signs.shape
    w = -(-nbits // 32)
    bits = torch.zeros((n, 32 * w), dtype=torch.int64, device=signs.device)
    bits[:, :nbits] = (signs > 0).to(torch.int64)
    shifts = torch.arange(32, device=signs.device, dtype=torch.int64)
    return (bits.reshape(n, w, 32) << shifts).sum(-1)


def popcount32(x):
    """Set bits of each 32-bit value held in an int64 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_topk(qwords, words, k, chunk=16_384):
    """Plain bit count on the card: the k smallest Hamming distances of each
    query over all rows (XOR, popcount), equal distances by the lower row;
    returns (distances (nq, k) float32, rows (nq, k) int64)."""
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import topk_ordered

    nq = qwords.shape[0]
    best_s = torch.full((nq, k), float("-inf"), device=DEVICE)
    best_p = torch.full((nq, k), -1, dtype=torch.int64, device=DEVICE)
    for c0 in range(0, words.shape[0], chunk):
        w = words[c0:c0 + chunk]
        ham = popcount32(qwords[:, None, :] ^ w[None, :, :]).sum(-1)
        pos = torch.arange(c0, c0 + w.shape[0], device=DEVICE)
        best_s, best_p = topk_ordered(
            torch.cat([best_s, -ham.to(torch.float32)], 1),
            torch.cat([best_p, pos.expand(nq, -1)], 1), k)
    return -best_s, best_p


def phase_lsh(smi, data):
    """Phase 23: LSHrt (128 bits) and ITQ64,LSH over phase 7's corpus,
    Hamming distances held exactly against a plain bit count on the card,
    labels tie-aware."""
    import duckdb_faiss_ext_tpu_torch as dt

    xb = data["xb"]
    for desc in LSH_FACTORIES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cat = dt.Catalog()
        t0 = time.perf_counter()
        dt.faiss_create("lsh", D, desc, metric_type="L2", catalog=cat)
        dt.faiss_add(xb, "lsh", catalog=cat)
        t_add = time.perf_counter() - t0
        top = cat.get("lsh").index
        lsh = getattr(top, "inner", top)
        codes = lsh._codes.device_vectors()
        check(codes.device.type == DEVICE and codes.dtype == torch.int8,
              f"{desc}: codes not int8 on the card")
        words = pack_words(codes[:N])
        parts = []
        for b in ("b48", "b1024"):
            res = dt.faiss_search("lsh", K, data[b], catalog=cat)
            xt = (top.apply_chain(data[b]) if top is not lsh else data[b])
            qw = pack_words(torch.from_numpy(lsh.encode(xt)).to(DEVICE))
            pd, pp = hamming_topk(qw, words, K)
            pd, pp = pd.cpu().numpy(), pp.cpu().numpy()
            check(np.array_equal(res["distance"], pd), f"{desc} {b}: Hamming "
                  f"distances differ from the plain bit count")
            # Tie-aware: each returned label has its reported distance, and
            # below the k-th distance both hold the same labels.
            own = popcount32(qw[:, None, :] ^ words[torch.from_numpy(
                res["label"]).to(DEVICE)]).sum(-1).cpu().numpy()
            check(np.array_equal(own, res["distance"]), f"{desc} {b}: a "
                  f"label's distance is not its Hamming distance")
            kth = pd[:, -1:]
            for q in range(pd.shape[0]):
                check(set(res["label"][q][res["distance"][q] < kth[q]])
                      == set(pp[q][pd[q] < kth[q]]), f"{desc} {b}: labels "
                      f"below the k-th distance differ at query {q}")
            parts.append(f"{b} faiss_search wall "
                         f"{walls_ms(lambda: dt.faiss_search('lsh', K, data[b], catalog=cat), reps=3):.3f} ms")  # noqa: E501
        log(f"lsh {desc} {N}x{D} ({lsh.nbits} bits, "
            f"{lsh._codes.vectors().nbytes / 2**20:.0f} MiB of int8 codes): "
            f"train + encode + add {t_add:.2f} s; Hamming distances equal to "
            f"the plain bit count, labels equal tie-aware at b48 and b1024; "
            f"{'; '.join(parts)}; card peak {peak_gib():.2f} GiB [{smi}]")
        del cat, top, lsh, codes, words


def range_reference(rows, labels, xq, radius, metric, probes=None,
                    assign=None, keep=None, chunk=1 << 15):
    """Plain dense range scan on the card: every stored row (fp32, storage
    order) against every query in full fp32, L2 in difference form, kept
    where it passes the radius (and the selector's ``keep``) and, for IVF,
    where its list ``assign`` is among the query's ``probes``.  Returns one
    {label: best distance} a query."""
    from duckdb_faiss_ext_tpu_torch.utils.config import full_fp32

    sim = metric == "INNER_PRODUCT"
    q = torch.from_numpy(xq).to(DEVICE)
    out = [dict() for _ in range(xq.shape[0])]
    hits = []
    with full_fp32():
        for c0 in range(0, rows.shape[0], chunk):
            r = rows[c0:c0 + chunk]
            dist = (q @ r.T if sim
                    else ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1))
            hit = dist > radius if sim else dist < radius
            if keep is not None:
                hit &= keep[None, c0:c0 + r.shape[0]]
            if probes is not None:
                a = assign[c0:c0 + r.shape[0]].long()
                hit &= (probes[:, :, None] == a[None, None, :]).any(1)
            qi, ri = torch.nonzero(hit, as_tuple=True)
            hits.append((qi.cpu().numpy(), (ri + c0).cpu().numpy(),
                         dist[qi, ri].cpu().numpy()))
    for qi, ri, di in hits:
        for a, lab, d in zip(qi, labels[ri], di):
            best = out[a].get(lab)
            if best is None or (d > best if sim else d < best):
                out[a][lab] = float(d)
    return out


def check_csr(tag, res, ref, radius, xq, metric):
    """Per query the same labels, leaving out rows whose reference distance
    lies within compare's tolerance of the radius; shared labels' distances
    within that tolerance; no label twice in a query.  Returns the max
    distance error."""
    lims = res["lims"]
    qn = (xq.astype(np.float64) ** 2).sum(1)
    err = 0.0
    for q, want in enumerate(ref):
        e = 0.0
        seg = slice(lims[q], lims[q + 1])
        got = dict(zip(res["label"][seg].tolist(),
                       res["distance"][seg].tolist()))
        check(len(got) == lims[q + 1] - lims[q], f"{tag}: a label repeats "
              f"in query {q}")
        tol = REL_TOL * max([abs(radius), qn[q] if metric == "L2" else 0.0]
                            + [abs(v) for v in want.values()])
        near = {lab for lab, d in want.items() if abs(d - radius) <= tol}
        check(set(got) - near == set(want) - near, f"{tag}: query {q} labels "
              f"differ from the plain dense scan")
        for lab in set(got) & set(want):
            e = max(e, abs(got[lab] - want[lab]))
        check(e <= tol, f"{tag}: query {q} distance error {e} above {tol}")
        err = max(err, e)
    return err


def phase_range(smi, data, ivf, pq, soar_cat):
    """Phase 24: faiss_range_search at b48 on phase 5's IDMap,Flat (with
    and without the id%2==0 selector), phase 7's IVF4096, phase 12's
    IVF4096,PQ16, phase 17's SQ8 and phase 22's SOAR index, each CSR held
    against a plain dense scan on the card; one statement through
    sql.dispatch."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops.ivf_scan import coarse_topk
    from duckdb_faiss_ext_tpu_torch.ops.pq import codec_decode
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_decode
    from duckdb_faiss_ext_tpu_torch.sql.dispatch import connect

    xq = data["b48"]
    xq_dev = torch.from_numpy(xq).to(DEVICE)
    flat = data["flat_cat"].get("sift").index
    sq8 = data["sq8_cat"].get("SQ8").index
    ivf_top = ivf["cat"].get("ivf").index
    pq_top = pq["cat"].get("pq").index
    soar = soar_cat.get("soar").index

    def ivf_rows(top):
        """Storage-order fp32 rows, labels, list assignments of an IVF."""
        inner = getattr(top, "inner", top)
        labels = inner._ids if top is inner else top._labels[inner._ids]
        if inner.pq_m is not None:
            cents = torch.from_numpy(inner._centroids).to(DEVICE)
            a = torch.from_numpy(inner._assign).to(DEVICE).long()
            cb = torch.from_numpy(inner._pq_codebooks).to(DEVICE)
            step = 1 << 18
            rows = torch.cat([
                codec_decode(torch.from_numpy(inner._codes[i:i + step]).to(
                    DEVICE), cb, inner.pq_codec) + cents[a[i:i + step]]
                for i in range(0, inner._nstored, step)])
        else:
            rows = torch.from_numpy(inner._xb).to(DEVICE)
        return inner, rows, labels, torch.from_numpy(inner._assign).to(DEVICE)

    even = flat.row_labels() % 2 == 0
    codes, vmin, scale = sq8._device_state()
    cases = [
        ("IDMap,Flat", data["flat_cat"], "sift", None, None, plain_k1),
        ("IDMap,Flat id%2==0", data["flat_cat"], "sift", None,
         dt.SetSelector(flat.row_labels()[even]), plain_k1),
        (f"IDMap,IVF4096,Flat nprobe {IVF_NPROBE}", ivf["cat"], "ivf",
         {"nprobe": str(IVF_NPROBE)}, None, plain_list_kernels),
        (f"IDMap,IVF4096,PQ16 nprobe {IVF_NPROBE}", pq["cat"], "pq",
         {"nprobe": str(IVF_NPROBE)}, None, plain_k8),
        ("SQ8", data["sq8_cat"], "SQ8", None, None, contextlib.nullcontext),
        (f"IVF4096,Flat SOAR nprobe {IVF_NPROBE}", soar_cat, "soar",
         {"nprobe": str(IVF_NPROBE)}, None, plain_list_kernels),
    ]
    refs = {
        "IDMap,Flat": (flat.inner.device_vectors()[:N], flat.row_labels()),
        "SQ8": (sq_decode(codes[:N], vmin, scale, "sq8"),
                np.arange(N, dtype=np.int64)),
    }
    for tag, cat, name, params, sel, plain in cases:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with plain():
            d10 = dt.faiss_search(name, K, xq, params,
                                  catalog=cat)["distance"][:, K - 1]
        radius = float(np.median(d10))
        t0 = time.perf_counter()
        res = dt.faiss_range_search(name, radius, xq, params, catalog=cat,
                                    selector=sel)
        wall = 1e3 * (time.perf_counter() - t0)
        peak = peak_gib()
        probes = assign = keep = None
        if tag.startswith("IDMap,Flat"):
            rows, labels = refs["IDMap,Flat"]
            if sel is not None:
                keep = torch.from_numpy(even).to(DEVICE)
        elif tag == "SQ8":
            rows, labels = refs["SQ8"]
        else:
            top = {"ivf": ivf_top, "pq": pq_top, "soar": soar}[name]
            inner, rows, labels, assign = ivf_rows(top)
            probes = coarse_topk(xq_dev, torch.from_numpy(
                inner._centroids).to(DEVICE), IVF_NPROBE, "L2")
        ref = range_reference(rows, labels, xq, radius, "L2", probes, assign,
                              keep)
        err = check_csr(f"range {tag}", res, ref, radius, xq, "L2")
        if sel is not None:
            check((res["label"] % 2 == 0).all(), "range: odd label")
        per_q = np.diff(res["lims"])
        log(f"range {tag} b48 radius {radius:.4f} (median plain 10th "
            f"distance): {int(res['lims'][-1])} results, "
            f"{int((per_q >= K).sum())} of {BATCH} queries with >= {K}; "
            f"agrees with the plain dense scan (max distance error "
            f"{err:.3g}); faiss_range_search wall {wall:.1f} ms, card peak "
            f"{peak:.2f} GiB [{smi}]")
    con = connect(catalog=data["flat_cat"], database=dt.Database())
    con.register("queries", {"data": xq[:4]})
    radius = float(np.median(dt.faiss_search("sift", K, xq[:4],
                                             catalog=data["flat_cat"])
                             ["distance"][:, K - 1]))
    rows = con.execute(f"SELECT faiss_range_search('sift', {radius}, data) "
                       f"FROM queries")
    api = dt.faiss_range_search("sift", radius, xq[:4],
                                catalog=data["flat_cat"])
    check([(r["query"], r["label"]) for r in rows]
          == [(q, int(lab)) for q in range(4)
              for lab in api["label"][api["lims"][q]:api["lims"][q + 1]]],
          "the SQL range route differs from the API")
    log(f"range through sql.dispatch: SELECT faiss_range_search('sift', "
        f"{radius:.4f}, data) FROM queries gives {len(rows)} rows, those of "
        f"the API")


#: phase 25: the reference's own benchmark index configs (BASELINE.md:14,
#: from Makefile:93 and go/benches_c.go:128-187): efConstruction 128,
#: efSearch 64, nprobe 15, k 10
HNSW_FACTORY, HNSW_EFC, HNSW_EFS = "IDMap,HNSW128,Flat", 128, 64
HNSW_EF_SWEEP, HNSW_RECALL_MIN = (16, 64, 128), 0.90
#: rows added after the build (a tail merged through K1, below the 20%
#: that rebuilds), and the rows of the card-against-CPU build (HNSW32;
#: the CPU's k-NN build is quadratic in them, ~23 s here)
HNSW_TAIL, HNSW_CPU_N, HNSW_CPU_M = 10_000, 32_768, 32
IVFH_FACTORY, IVFH_NPROBE = "IVF2048_HNSW128,Flat", 15
IVFH_PARAMS = {"nprobe": str(IVFH_NPROBE), "quantiser.efSearch": "64"}
#: the graph at the ada-002 width over phase 8's corpus
NSG_FACTORY, NSG_SEARCH_L = "NSG32", 64


def graph_result_check(tag, res, rows, xq, metric):
    """Every returned distance equals the fp32 distance of its row (taken
    in difference form for L2) within REL_TOL of the larger of the query's
    largest |distance| and |q|^2; no label twice in a query.  ``rows``
    maps labels to (nq, k, d) rows on the card."""
    labels = res["label"]
    check(np.isfinite(res["distance"]).all() and (labels >= 0).all(),
          f"{tag}: missing results")
    for row in labels:
        check(len(set(row.tolist())) == len(row),
              f"{tag}: a label repeats within a query")
    q = torch.from_numpy(xq).to(DEVICE)
    r = rows(labels)
    if metric == "L2":
        ref = ((r - q[:, None, :]) ** 2).sum(-1)
    else:
        ref = (r * q[:, None, :]).sum(-1)
    ref = ref.cpu().numpy()
    tol = REL_TOL * np.maximum(np.abs(ref).max(1),
                               (xq.astype(np.float64) ** 2).sum(1))
    err = np.abs(res["distance"] - ref)
    check((err <= tol[:, None]).all(), f"{tag}: distance error "
          f"{err.max()} above tolerance")
    return float(err.max())


def walk_shape(index, params, k=K):
    """(pool, width, iterations) of the index's walk under ``params``."""
    from duckdb_faiss_ext_tpu_torch.ops.graph import default_iters
    from duckdb_faiss_ext_tpu_torch.params import ParamMap

    p = ParamMap(params)
    index._latch(p)
    pool, width, iters = index._walk_knobs(k, p, None)
    pool = max(pool, k)
    return pool, width, iters or default_iters(pool, width,
                                               index._graph_degree())


def device_total_ms(fn, reps=3):
    """Summed device time of every kernel of ``fn`` a call
    (torch.profiler, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / (
        1e3 * reps)


def graph_build_seconds():
    from duckdb_faiss_ext_tpu_torch.utils.profiling import stats

    return stats().get("hnsw_graph_build", {}).get("total_s", 0.0)


def phase_graph(smi, data, exact):
    """Phase 25: IDMap,HNSW128,Flat over the 1M x 128 corpus (the graph
    built at the first search, walks at three efSearch values, batched,
    filtered, exact, a tail, save / load), the same graph code on the card
    and on the CPU over 32,768 rows, IVF2048_HNSW128,Flat, and NSG32 and
    HNSW32 accel=ivf at 262,144 x 1536.  Returns the K1 and K6 / K7
    launches of the searches."""
    import tempfile

    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops import graph as graph_ops
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu_torch.utils.config import next_pow2, pad_rows

    xb, ids = data["xb"], data["ids"]
    queries = {b: data[b] for b in ("b48", "b1024")}
    launches = {"k1": 0, "k6": 0, "k7": 0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 1. IDMap,HNSW128,Flat: the graph is built by the first search.
    cat = dt.Catalog()
    dt.faiss_create_params("hnsw", D, HNSW_FACTORY,
                           {"efConstruction": str(HNSW_EFC)},
                           metric_type="L2", catalog=cat)
    index = cat.get("hnsw").index.inner
    t0 = time.perf_counter()
    dt.faiss_add((ids, xb), "hnsw", catalog=cat)
    t_add = time.perf_counter() - t0
    ft.LAUNCHES = 0
    built0 = graph_build_seconds()
    params = {"efSearch": str(HNSW_EFS)}
    t0 = time.perf_counter()
    first = dt.faiss_search("hnsw", K, queries["b48"], params, catalog=cat)
    t_first = time.perf_counter() - t0
    t_build = graph_build_seconds() - built0
    deg = index._graph_degree()
    inter = min(max(2 * deg, index.ef_construction), N - 1, 192)
    build_k1 = -(-N // graph_ops._KNN_BLOCK)
    check(index._effective_mode() == "graph" and index._graph[1] == N,
          "hnsw: no graph over the corpus")
    check((deg, inter) == (128, 192), f"hnsw: degree {deg}, intermediate "
          f"{inter}")
    check(ft.LAUNCHES == build_k1, f"hnsw build: {ft.LAUNCHES} K1 "
          f"launches, not {build_k1}")
    launches["k1"] += ft.LAUNCHES
    adj = index._graph[0]
    log(f"hnsw {HNSW_FACTORY} {N}x{D} L2 efConstruction {HNSW_EFC}: add "
        f"{t_add:.2f} s; graph built by the first faiss_search in "
        f"{t_build:.2f} s (the call {t_first:.2f} s; {build_k1} K1 "
        f"launches at k = {inter + 1}): degree {deg}, intermediate degree "
        f"{inter}, adjacency {adj.nbytes / 2**20:.1f} MiB on the host and "
        f"{index._graph_dev[1].numel() * 4 / 2**20:.1f} MiB on the card; "
        f"card peak {peak_gib():.2f} GiB [{smi}]")

    corpus = index.device_vectors()

    def rows(labels):
        return corpus[torch.from_numpy(labels).to(DEVICE)]

    err, recs, parts = 0.0, {}, []
    ft.LAUNCHES = 0
    for ef in HNSW_EF_SWEEP:
        p = {"efSearch": str(ef)}
        for b, xq in queries.items():
            res = dt.faiss_search("hnsw", K, xq, p, catalog=cat)
            err = max(err, graph_result_check(f"hnsw ef{ef} {b}", res, rows,
                                              xq, "L2"))
            recs[(ef, b)] = recall(res["label"], exact[b])
            if ef == HNSW_EFS:
                check(recs[(ef, b)] >= HNSW_RECALL_MIN, f"hnsw ef{ef} {b}: "
                      f"recall@10 {recs[(ef, b)]:.4f} below "
                      f"{HNSW_RECALL_MIN}")
            pool, width, iters = walk_shape(index, p)
            wall = walls_ms(lambda: dt.faiss_search("hnsw", K, xq, p,
                                                    catalog=cat), reps=3)
            dev = device_total_ms(lambda: dt.faiss_search("hnsw", K, xq, p,
                                                          catalog=cat))
            parts.append(f"ef{ef} {b}: recall@10 {recs[(ef, b)]:.4f}, pool "
                         f"{pool} width {width} {iters} iterations, "
                         f"faiss_search wall {wall:.3f} ms, device "
                         f"{dev:.3f} ms ({dev / iters:.3f} ms an iteration)")
    check(ft.LAUNCHES == 0, f"hnsw walks launched K1 {ft.LAUNCHES} times")
    check(np.array_equal(first["label"], dt.faiss_search(
        "hnsw", K, queries["b48"], params, catalog=cat)["label"]),
        "hnsw: the first search differs from a later one")
    log(f"hnsw walks (max distance error {err:.3g}, no K1 launch): "
        f"{'; '.join(parts)} [{smi}]")

    xq_b = data["batched"]
    bat = dt.faiss_search_batched("hnsw", K, xq_b, params, batch_size=BATCH,
                                  catalog=cat)
    seq = [dt.faiss_search("hnsw", K, xq_b[s:s + BATCH], params, catalog=cat)
           for s in range(0, xq_b.shape[0], BATCH)]
    for key in ("label", "distance"):
        check(np.array_equal(bat[key], np.concatenate([s[key] for s in seq])),
              f"hnsw batched: {key}s differ from the sequential calls")
    db = dt.Database()
    db.register("base", {"id": ids})
    filt = dt.faiss_search_filter("hnsw", K, queries["b48"], "id%2==0", "id",
                                  "base", params, catalog=cat, database=db)
    check((filt["label"] % 2 == 0).all(), "hnsw filter: an odd label")
    graph_result_check("hnsw filter", filt, rows, queries["b48"], "L2")
    ft.LAUNCHES = 0
    ex = dt.faiss_search("hnsw", K, queries["b48"], {"exact": "true"},
                         catalog=cat)
    check(ft.LAUNCHES == 1, f"hnsw exact: {ft.LAUNCHES} K1 launches")
    check(np.array_equal(ex["label"], exact["b48"]),
          "hnsw exact: labels differ from phase 5's")
    launches["k1"] += 1
    filt_exact = dt.faiss_search("hnsw", K, queries["b48"], {"exact": "true"},
                                 catalog=cat,
                                 selector=dt.SetSelector(ids[::2]))["label"]
    log(f"hnsw: faiss_search_batched {xq_b.shape[0] // BATCH} x b{BATCH} "
        f"equal to the sequential calls bit for bit; filter id%2==0 "
        f"recall@10 against the filtered exact scan "
        f"{recall(filt['label'], filt_exact):.4f}; exact: one K1 launch, "
        f"phase 5's labels")

    # A tail below the rebuild fraction: merged through K1, no rebuild.
    rng = np.random.default_rng(43)
    tail = (xb[rng.integers(0, N, HNSW_TAIL)]
            + rng.standard_normal((HNSW_TAIL, D), dtype=np.float32) * 0.5)
    tail_ids = np.arange(N, N + HNSW_TAIL, dtype=np.int64)
    graph_before = index._graph
    dt.faiss_add((tail_ids, tail), "hnsw", catalog=cat)
    corpus = index.device_vectors()
    ft.LAUNCHES = 0
    built0 = graph_build_seconds()
    tq = tail[:BATCH]
    res_t = dt.faiss_search("hnsw", K, tq, params, catalog=cat)
    check(ft.LAUNCHES == 1 and index._graph is graph_before
          and graph_build_seconds() == built0,
          f"hnsw tail: {ft.LAUNCHES} K1 launches, rebuilt "
          f"{index._graph is not graph_before}")
    check((res_t["label"][:, 0] == tail_ids[:BATCH]).all(),
          "hnsw tail: a tail row does not find itself")
    graph_result_check("hnsw tail", res_t, rows, tq, "L2")
    launches["k1"] += 1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hnsw.idx")
        t0 = time.perf_counter()
        dt.faiss_save("hnsw", path, catalog=cat)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        dt.faiss_load("hnsw2", path, catalog=cat)
        t_load = time.perf_counter() - t0
    loaded = cat.get("hnsw2").index.inner
    ft.LAUNCHES = 0
    again = dt.faiss_search("hnsw2", K, tq, params, catalog=cat)
    check(ft.LAUNCHES == 1 and graph_build_seconds() == built0
          and loaded._graph[1] == N, "hnsw load: rebuilt or no tail merge")
    launches["k1"] += 1
    for key in ("label", "distance"):
        check(np.array_equal(again[key], res_t[key]),
              f"hnsw load: {key}s differ")
    log(f"hnsw tail of {HNSW_TAIL} rows: b{BATCH} of tail rows merged "
        f"through one K1 launch, no rebuild, each finds itself; save "
        f"{t_save:.2f} s, load {t_load:.2f} s, equal results, no rebuild; "
        f"card peak {peak_gib():.2f} GiB [{smi}]")
    del cat, index, loaded, corpus
    torch.cuda.empty_cache()

    # 2. The same graph code on the card and on the CPU (HNSW32's degree).
    n_small = HNSW_CPU_N
    deg_s = min(128, max(16, 2 * HNSW_CPU_M))
    inter_s = min(max(2 * deg_s, 40), n_small - 1, 192)
    cpu_rows = torch.from_numpy(np.ascontiguousarray(xb[:n_small]))
    card_rows = cpu_rows.to(DEVICE)
    t0 = time.perf_counter()
    knn_card = graph_ops.build_knn_graph(card_rows, n_small, inter_s, "L2")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    knn_cpu = graph_ops.build_knn_graph(cpu_rows, n_small, inter_s, "L2")
    t_cpu = time.perf_counter() - t0
    kc, kp = knn_card.cpu().numpy(), knn_cpu.numpy()
    d_nb = ((card_rows[knn_card.long()] - card_rows[:, None, :]) ** 2).sum(
        -1).cpu().numpy()
    beyond = graph_ops.build_knn_graph(card_rows, n_small, inter_s + 1,
                                       "L2")[:, -1:].long()
    d_next = ((card_rows[beyond] - card_rows[:, None, :]) ** 2).sum(
        -1).cpu().numpy()
    key = np.concatenate([d_nb, d_next], 1)
    tol = REL_TOL * np.maximum(key.max(1), (xb[:n_small].astype(np.float64)
                                            ** 2).sum(1))
    gap = np.abs(np.diff(key, axis=1)) > 2 * tol[:, None]
    sep = gap.copy()
    sep[:, 1:] &= gap[:, :-1]
    bad = np.argwhere(sep & (kc != kp))
    check(not bad.size, f"card / CPU k-NN graphs differ at {bad[:5].tolist()}")
    adj_card = graph_ops.augment_graph(knn_card, deg_s)
    check(torch.equal(adj_card.cpu(), graph_ops.augment_graph(knn_card.cpu(),
                                                              deg_s)),
          "augment_graph differs between the card and the CPU")
    same_rows = float((graph_ops.augment_graph(knn_cpu, deg_s).numpy()
                       == adj_card.cpu().numpy()).all(1).mean())
    cap_s = next_pow2(n_small)
    pad = torch.full((cap_s - n_small, deg_s), -1, dtype=torch.int32)
    g_card = torch.cat([adj_card, pad.to(DEVICE)])
    xq48 = pad_rows(queries["b48"], 64)
    width_s = max(4, 512 // deg_s)
    walk = {}
    for dev, rows_t, g in ((DEVICE, card_rows, g_card),
                           ("cpu", cpu_rows, g_card.cpu())):
        s, p = graph_ops.graph_search(
            rows_t, g, torch.from_numpy(xq48).to(dev), n_small, K, "L2",
            pool=next_pow2(HNSW_EFS), width=width_s)
        walk[dev] = [t.cpu().numpy()[:BATCH]
                     for t in finalize_scores(s, p, "L2")]
    wd, wl = walk["cpu"]
    check(np.abs(walk[DEVICE][0] - wd).max()
          <= REL_TOL * max(np.abs(wd).max(),
                           float((xq48 ** 2).sum(1).max())),
          "card / CPU walks: distances differ")
    wgap = np.abs(np.diff(wd, axis=1)) > 2 * REL_TOL * max(
        np.abs(wd).max(), float((xq48 ** 2).sum(1).max()))
    wsep = np.ones_like(wl, dtype=bool)
    wsep[:, 1:] &= wgap
    wsep[:, :-1] &= wgap
    check(np.array_equal(walk[DEVICE][1][wsep], wl[wsep]),
          "card / CPU walks: labels differ")
    log(f"graph code card against CPU, {n_small}x{D} L2 degree {deg_s} "
        f"(intermediate {inter_s}): k-NN graphs equal wherever the "
        f"neighbouring distances are apart ({sep.mean():.4f} of the "
        f"entries), augment_graph byte-equal on the same input, "
        f"{same_rows:.4f} of the augmented rows equal from each side's own "
        f"k-NN graph; k-NN build card {t_card:.2f} s, CPU {t_cpu:.2f} s; "
        f"the walk at b{BATCH} pool {next_pow2(HNSW_EFS)} over the card's "
        f"adjacency equal on both [{smi}]")
    del cpu_rows, card_rows, knn_card, knn_cpu, adj_card, g_card, beyond
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 3. IVF2048_HNSW128,Flat: an HNSW coarse quantizer.
    cat = dt.Catalog()
    dt.faiss_create("ivfh", D, IVFH_FACTORY, metric_type="L2", catalog=cat)
    t0 = time.perf_counter()
    dt.faiss_manual_train(xb[:IVF_TRAIN], "ivfh", catalog=cat)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt.faiss_add(xb, "ivfh", catalog=cat)
    t_add = time.perf_counter() - t0
    ivfh = cat.get("ivfh").index
    quant = ivfh.quantizer
    check(type(quant).__name__ == "HNSWIndex" and quant.ntotal == ivfh.nlist
          and quant.M == 128, "ivfh: the quantizer is not an HNSW128 "
          "holding the centroids")
    recs_i, err_i, text = list_path_check(
        f"ivfh nprobe {IVFH_NPROBE}", dt, cat, "ivfh", ivfh, queries,
        IVFH_PARAMS, exact)
    lmax = ivfh._build_device_layout().payload.shape[1]
    k6w, k7w = map(sum, zip(*(expected_list_launches(ivfh, q.shape[0],
                                                     IVFH_NPROBE, lmax)
                              for q in queries.values())))
    launches["k6"] += k6w
    launches["k7"] += k7w
    log(f"ivfh {IVFH_FACTORY} {N}x{D} L2: train {t_train:.2f} s on "
        f"{IVF_TRAIN} rows (the HNSW128 quantizer holds the {ivfh.nlist} "
        f"centroids), add {t_add:.2f} s, lmax {lmax}; {IVFH_PARAMS}: {text}; "
        f"card peak {peak_gib():.2f} GiB [{smi}]")
    del cat, ivfh, quant
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 4. NSG32 and HNSW32 accel=ivf at the ada-002 width (phase 8's corpus).
    xb8, xq8 = clustered_f32(PAIRS_N, PAIRS_D, BATCH + BIG_BATCH, PAIRS_NLIST,
                             seed=7)
    q8 = {"b48": xq8[:BATCH], "b1024": xq8[BATCH:]}
    rows8 = torch.from_numpy(xb8).to(DEVICE)
    exact8 = {b: decoded_k1(rows8, PAIRS_N, q, "INNER_PRODUCT", width=K)[1]
              for b, q in q8.items()}
    cat = dt.Catalog()
    dt.faiss_create("nsg", PAIRS_D, NSG_FACTORY,
                    metric_type="INNER_PRODUCT", catalog=cat)
    dt.faiss_add(xb8, "nsg", catalog=cat)
    nsg = cat.get("nsg").index
    p_nsg = {"search_L": str(NSG_SEARCH_L)}
    ft.LAUNCHES = 0
    built0 = graph_build_seconds()
    t0 = time.perf_counter()
    dt.faiss_search("nsg", K, q8["b48"], p_nsg, catalog=cat)
    t_first = time.perf_counter() - t0
    t_build = graph_build_seconds() - built0
    nsg_k1 = -(-PAIRS_N // graph_ops._KNN_BLOCK)
    check(ft.LAUNCHES == nsg_k1 and nsg._graph is not None,
          f"nsg build: {ft.LAUNCHES} K1 launches, not {nsg_k1}")
    launches["k1"] += ft.LAUNCHES
    parts = []

    def rows8_of(labels):
        return rows8[torch.from_numpy(labels).to(DEVICE)]

    for b, q in q8.items():
        res = dt.faiss_search("nsg", K, q, p_nsg, catalog=cat)
        graph_result_check(f"nsg {b}", res, rows8_of, q, "INNER_PRODUCT")
        pool, width, iters = walk_shape(nsg, p_nsg)
        wall = walls_ms(lambda: dt.faiss_search("nsg", K, q, p_nsg,
                                                catalog=cat), reps=3)
        dev = device_total_ms(lambda: dt.faiss_search("nsg", K, q, p_nsg,
                                                      catalog=cat))
        parts.append(f"{b}: recall@10 {recall(res['label'], exact8[b]):.4f},"
                     f" pool {pool} width {width} {iters} iterations, "
                     f"faiss_search wall {wall:.3f} ms, device {dev:.3f} ms "
                     f"({dev / iters:.3f} ms an iteration)")
    log(f"nsg {NSG_FACTORY} {PAIRS_N}x{PAIRS_D} IP search_L {NSG_SEARCH_L}: "
        f"graph built by the first faiss_search in {t_build:.2f} s (the "
        f"call {t_first:.2f} s; {nsg_k1} K1 launches): degree "
        f"{nsg._graph_degree()}; {'; '.join(parts)}; card peak "
        f"{peak_gib():.2f} GiB [{smi}]")
    del nsg, cat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    cat = dt.Catalog()
    dt.faiss_create_params("hacc", PAIRS_D, "HNSW32", {"accel": "ivf"},
                           metric_type="INNER_PRODUCT", catalog=cat)
    dt.faiss_add(xb8, "hacc", catalog=cat)
    hacc = cat.get("hacc").index
    p_acc = {"efSearch": str(HNSW_EFS)}
    k6.LAUNCHES = k6.TOPK_LAUNCHES = k7.LAUNCHES = k7.TOPK_LAUNCHES = 0
    t0 = time.perf_counter()
    out = {b: dt.faiss_search("hacc", K, q, p_acc, catalog=cat)
           for b, q in q8.items()}
    t_first = time.perf_counter() - t0
    accel = hacc._accel[0]
    fused = (k6.TOPK_LAUNCHES, k7.TOPK_LAUNCHES)
    check(hacc._graph is None and accel.nlist == next_pow2(
        int(np.ceil(np.sqrt(PAIRS_N)))) and fused[0] >= 1
          and k6.LAUNCHES == k7.LAUNCHES == 0, f"hacc: nlist {accel.nlist}, "
          f"(K6, K7) fused launches {fused}")
    launches["k6"] += fused[0]
    launches["k7"] += fused[1]
    parts = []
    for b, q in q8.items():
        graph_result_check(f"hacc {b}", out[b], rows8_of, q, "INNER_PRODUCT")
        wall = walls_ms(lambda: dt.faiss_search("hacc", K, q, p_acc,
                                                catalog=cat), reps=3)
        parts.append(f"{b}: recall@10 {recall(out[b]['label'], exact8[b]):.4f}"
                     f", faiss_search wall {wall:.3f} ms")
    log(f"hacc HNSW32 accel=ivf {PAIRS_N}x{PAIRS_D} IP efSearch {HNSW_EFS} "
        f"(nprobe {max(1, round(HNSW_EFS / 4))} of IVF{accel.nlist}, k-means "
        f"{accel.train_niter} iterations): partition built by the first "
        f"searches in {t_first:.2f} s; (K6, K7) fused launches {fused}; "
        f"{'; '.join(parts)}; card peak {peak_gib():.2f} GiB [{smi}]")
    del cat, hacc, accel, rows8
    torch.cuda.empty_cache()
    return launches


#: phase 26: the placement tier on one card, every mesh a grid of cuda:0
#: repeated; the IVF,SQ8 leg at the ada-002 width over the first
#: SQ_PLACE_N rows of phase 10's generator (IVF1024: the sharded layout
#: has no list cap, and IVF4096's longest lists would pad it past 20 GB)
PLACE_SHARDS, SQ_PLACE_N, SQ_PLACE_NLIST = 4, 1_048_576, 1024
#: the share of the placed IVF,SQ8 leg's queries whose distances may differ
#: from the unplaced index's: each shard keeps its own best k_scan rows by
#: the int8 scores, a superset of the unplaced index's pool, so the fp32
#: rescore can only find a better row, which is rare (0 of 1,072 queries in
#: the first runs)
SQ_PLACE_DIFFER_MAX = 0.01
DEMO_TIMEOUT = 300


def placed_meshes():
    """(label, devices argument) of phase 26's Flat placements:
    faiss_to_device's default (every card: one shard here), a 4 x 1 and a
    2 x 2 mesh of cuda:0."""
    from duckdb_faiss_ext_tpu_torch.parallel.sharded import make_mesh

    return (("faiss_to_device(name)", None),
            ("4x1 mesh", make_mesh(PLACE_SHARDS)),
            ("2x2 mesh", make_mesh(PLACE_SHARDS, batch_axis=2)))


def shard_loads(index):
    """Per-shard Σcounts of a placed IVF index under its LPT perm."""
    counts = index._counts()
    perm = index._shard_perm
    npl = counts.shape[0] // index._shard_mesh.shape["shard"]
    return [int(counts[perm[s * npl:(s + 1) * npl]].sum())
            for s in range(index._shard_mesh.shape["shard"])]


@contextlib.contextmanager
def mask_paths():
    """Record every mask the IVF layouts build: (the selector type
    device_row_mask was given, with its base for an IDMap's
    LabelMapSelector, and the mask's device)."""
    from duckdb_faiss_ext_tpu_torch.models import ivf_layout

    real, seen = ivf_layout.device_row_mask, []

    def recorded(sel, row_pos, labels):
        mask = real(sel, row_pos, labels)
        base = getattr(sel, "base", None)
        seen.append((type(sel).__name__ + (f"({type(base).__name__})"
                                           if base is not None else ""),
                     mask.device))
        return mask

    ivf_layout.device_row_mask = recorded
    try:
        yield seen
    finally:
        ivf_layout.device_row_mask = real


def describe_masks(seen):
    """'n masks by device_row_mask from <selector> on <device>' per kind."""
    kinds = sorted(set(seen), key=str)
    return "; ".join(f"{seen.count(k)} by device_row_mask from {k[0]} on "
                     f"{k[1]}" for k in kinds) or "none"


def placed_ivf_leg(tag, dt, cat, name, queries, params, sel, counter, smi):
    """Search an IVF index unplaced (b48, b1024, filtered b48), place it 4
    ways, search again: every placed result held against the unplaced one
    (labels equal where distances are apart).  Returns (launches, error)."""
    from duckdb_faiss_ext_tpu_torch.parallel.sharded import make_mesh

    def run():
        out = {b: dt.faiss_search(name, K, xq, params, catalog=cat)
               for b, xq in queries.items()}
        out["filter"] = dt.faiss_search(name, K, queries["b48"], params,
                                        catalog=cat, selector=sel)
        return out

    with mask_paths() as ref_seen:
        ref = run()
    ref_walls = {b: walls_ms(lambda: dt.faiss_search(name, K, xq, params,
                                                     catalog=cat), reps=3)
                 for b, xq in queries.items()}
    t0 = time.perf_counter()
    dt.faiss_to_device(name, make_mesh(PLACE_SHARDS), catalog=cat)
    index = cat.get(name).index
    index = getattr(index, "inner", index)
    index._build_sharded()
    t_place = time.perf_counter() - t0
    counter.reset()
    with mask_paths() as seen:
        out = run()
    n = counter.read()
    check(len(seen) == PLACE_SHARDS and all(
        dev.type == torch.device(DEVICE).type for _, dev in seen),
        f"{tag}: placed masks {seen}")
    err = max(compare_same_k(f"{tag} placed {b}", out[b], ref[b], False)
              for b in out)
    check((out["filter"]["label"] % 2 == 0).all(), f"{tag}: odd label")
    loads = shard_loads(index)
    w = {b: walls_ms(lambda: dt.faiss_search(name, K, xq, params,
                                             catalog=cat), reps=3)
         for b, xq in queries.items()}
    log(f"phase 26 {tag} placed {PLACE_SHARDS} ways (LPT, sharded layout "
        f"{t_place:.2f} s, lmax {index._sharded_cache[2]}): per-shard "
        f"Σcounts {loads}, max/mean {max(loads) / np.mean(loads):.4f}; "
        f"{counter.label} launches {n} for b48 + b1024 + filtered b48; "
        f"the filtered search's shard masks: {describe_masks(seen)} "
        f"(unplaced: {describe_masks(ref_seen)}); "
        f"equal to the unplaced index (max distance error {err:.3g}); "
        f"faiss_search wall b48 {w['b48']:.3f} ms (unplaced "
        f"{ref_walls['b48']:.3f}), b1024 {w['b1024']:.3f} ms (unplaced "
        f"{ref_walls['b1024']:.3f}) [{smi}]")
    return n, err


class LaunchCounter:
    """The summed launch counters of some kernels' modules."""

    def __init__(self, label, *counters):
        self.label, self.counters = label, counters

    def reset(self):
        for mod, attr in self.counters:
            setattr(mod, attr, 0)

    def read(self):
        return tuple(getattr(mod, attr) for mod, attr in self.counters)


def phase_placement(smi, data, exact, ivf, pq):
    """Phase 26, the 1M x 128 legs: faiss_to_device of phase 5's
    IDMap,Flat (one shard, 4 x 1, 2 x 2), phase 7's IDMap,IVF4096,Flat and
    phase 12's IDMap,IVF4096,PQ16 (4 ways, LPT), a sharded
    IDMap,HNSW128,Flat (graph_sharded, four builds on K1),
    multichip_dryrun(4) and the two-process demo.  Returns the K1 / K6 /
    K7 / K8 launches of the placed paths."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import flat_topk as ft
    from duckdb_faiss_ext_tpu_torch.ops import ivf_list_scan as k6
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pairs as k7
    from duckdb_faiss_ext_tpu_torch.ops import ivf_pq_scan as k8
    from duckdb_faiss_ext_tpu_torch.parallel.sharded import (
        make_mesh, multichip_dryrun)

    t_phase = time.perf_counter()
    queries = {b: data[b] for b in ("b48", "b1024")}
    launches = {"k1": 0, "k6": 0, "k7": 0, "k8": 0}
    err = 0.0

    # Flat: phase 5's IDMap,Flat under three placements.
    cat = data["flat_cat"]
    ref = {b: dt.faiss_search("sift", K, xq, catalog=cat)
           for b, xq in queries.items()}
    ref_walls = {b: walls_ms(lambda: dt.faiss_search("sift", K, xq,
                                                     catalog=cat))
                 for b, xq in queries.items()}
    for label, devices in placed_meshes():
        dt.faiss_to_device("sift", devices, catalog=cat)
        blocks = cat.get("sift").index.inner.device_vectors()
        # K1 on every block that holds rows, for every part of the batch
        per_search = blocks.mesh.shape["batch"] * sum(
            blocks.nvalid(s, N) > 0 for s in range(blocks.nshards))
        ft.LAUNCHES = 0
        out = {b: dt.faiss_search("sift", K, xq, catalog=cat)
               for b, xq in queries.items()}
        n = ft.LAUNCHES
        check(n == 2 * per_search, f"placed flat {label}: K1 launched {n} "
              f"times, not {2 * per_search}")
        launches["k1"] += n
        for b in out:
            err = max(err, compare_same_k(f"placed flat {label} {b}",
                                          out[b], ref[b], False))
        w = {b: walls_ms(lambda: dt.faiss_search("sift", K, xq,
                                                 catalog=cat))
             for b, xq in queries.items()}
        log(f"phase 26 flat {N}x{D} L2 k={K} {label}: K1 {per_search} "
            f"launches a search, equal to the unplaced search; faiss_search "
            f"wall b48 {w['b48']:.3f} ms (unplaced {ref_walls['b48']:.3f}), "
            f"b1024 {w['b1024']:.3f} ms (unplaced "
            f"{ref_walls['b1024']:.3f}) (medians of 5) [{smi}]")

    # IVF4096,Flat and IVF4096,PQ16 4 ways, a 50% bitmap filter built by
    # create_mask through the native bitmapper.
    ids = data["ids"]
    sel = dt.create_mask((ids % 2 == 0).astype(np.uint8), ids)
    params = {"nprobe": str(IVF_NPROBE)}
    n, e = placed_ivf_leg(
        f"IDMap,IVF4096,Flat {N}x{D} L2 nprobe {IVF_NPROBE}", dt,
        ivf["cat"], "ivf", queries, params, sel,
        LaunchCounter("(K6 fused, K7 fused)", (k6, "TOPK_LAUNCHES"),
                      (k7, "TOPK_LAUNCHES")), smi)
    check(n[0] + n[1] == 3 * PLACE_SHARDS, f"placed IVF: (K6, K7) {n}")
    launches["k6"] += n[0]
    launches["k7"] += n[1]
    err = max(err, e)
    pq_index = pq["index"]
    for attr in ("LAYOUT_BUDGET_BYTES", "SPILL_FRACTION_MAX"):
        pq_index.__dict__.pop(attr, None)   # phase 13's cap off again
    pq_index._invalidate()
    n, e = placed_ivf_leg(
        f"{PQ_FACTORY} {N}x{D} L2 nprobe {IVF_NPROBE}", dt, pq["cat"], "pq",
        queries, params, sel, LaunchCounter("K8", (k8, "LAUNCHES")), smi)
    check(n[0] == 3 * PLACE_SHARDS, f"placed PQ: K8 {n}")
    launches["k8"] += n[0]
    err = max(err, e)

    # IDMap,HNSW128,Flat in graph_sharded: four per-shard builds on K1.
    hcat = dt.Catalog()
    dt.faiss_create_params("hs", D, HNSW_FACTORY,
                           {"efConstruction": str(HNSW_EFC)},
                           metric_type="L2", catalog=hcat)
    dt.faiss_add((ids, data["xb"]), "hs", catalog=hcat)
    dt.faiss_to_device("hs", make_mesh(PLACE_SHARDS), catalog=hcat)
    hix = hcat.get("hs").index.inner
    check(hix._effective_mode() == "graph_sharded", "hnsw: not sharded")
    hparams = {"efSearch": str(HNSW_EFS)}
    ft.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = dt.faiss_search("hs", K, queries["b48"], hparams, catalog=hcat)
    t_build = time.perf_counter() - t0
    n_build = ft.LAUNCHES
    out = {"b48": first, "b1024": dt.faiss_search(
        "hs", K, queries["b1024"], hparams, catalog=hcat)}
    check(ft.LAUNCHES == n_build and n_build > 0,
          f"hnsw sharded: K1 {n_build} build launches, walks launched it")
    launches["k1"] += n_build
    parts = []
    for b, res in out.items():
        check(np.isfinite(res["distance"]).all(), f"hnsw sharded {b}")
        r = recall(res["label"], exact[b])
        check(r >= HNSW_RECALL_MIN, f"hnsw sharded {b}: recall {r}")
        w = walls_ms(lambda: dt.faiss_search("hs", K, queries[b], hparams,
                                             catalog=hcat))
        parts.append(f"{b} recall@10 {r:.4f}, walk wall {w:.3f} ms")
    log(f"phase 26 {HNSW_FACTORY} {N}x{D} L2 graph_sharded over "
        f"{PLACE_SHARDS} shards (valid rows {hix._graph_sharded[2]}): the "
        f"first search built the per-shard graphs in {t_build:.2f} s with "
        f"{n_build} K1 launches; efSearch {HNSW_EFS}: {'; '.join(parts)} "
        f"[{smi}]")
    del hcat, hix

    t0 = time.perf_counter()
    multichip_dryrun(PLACE_SHARDS)
    log(f"phase 26 multichip_dryrun({PLACE_SHARDS}) on cuda:0 repeated: "
        f"every sharded path agrees with its numpy oracle "
        f"({time.perf_counter() - t0:.2f} s)")

    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    demo = subprocess.run(
        [sys.executable, "-m",
         "duckdb_faiss_ext_tpu_torch.parallel.multihost_demo", "--n", str(N),
         "--d", str(D), "--timeout", str(DEMO_TIMEOUT - 20),
         *(["--cpu"] if DEVICE == "cpu" else [])],
        capture_output=True, text=True, cwd=HERE, timeout=DEMO_TIMEOUT,
        env=dict(os.environ, DFX_DEMO_PORT=str(port)))
    ok = [ln for ln in demo.stdout.splitlines() if "MULTIHOST OK" in ln]
    check(demo.returncode == 0 and ok, f"multihost demo exited "
          f"{demo.returncode}: {demo.stdout[-1500:]} {demo.stderr[-1500:]}")
    log(f"phase 26 multihost demo ({time.perf_counter() - t0:.1f} s): "
        f"{ok[0]} [{smi}]")
    log(f"phase 26 (1M x 128 legs) {time.perf_counter() - t_phase:.1f} s; "
        f"max distance error against the unplaced indexes {err:.3g}")
    return launches, err


def phase_placement_sq(smi):
    """Phase 26, the IVF,SQ8 leg: IVF1024,SQ8 inner product over the first
    1,048,576 rows of phase 10's 1536-d generator, fast mode, nprobe 16,
    placed 4 ways: b48 through K2 and b1024 through K3 on every shard.
    Every returned distance is held to its label's score recomputed from
    the decoded codes.  The int8 pools differ per shard, so a placed result
    is held to be at least as good as the unplaced one at every rank
    (within the tolerance) and equal to it wherever their distances agree,
    which must be all but SQ_PLACE_DIFFER_MAX of the queries.  Returns
    ((K2, K3) launches, error)."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_pairs as k3
    from duckdb_faiss_ext_tpu_torch.ops import ivf_sq_scan as k2
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_decode
    from duckdb_faiss_ext_tpu_torch.parallel.sharded import make_mesh

    t_phase = time.perf_counter()
    corpus = marco_corpus()
    xq_all = corpus.queries(BATCH + BIG_BATCH)
    queries = {"b48": xq_all[:BATCH], "b1024": xq_all[BATCH:]}
    cat = dt.Catalog()
    params = {"nprobe": str(SQ_NPROBE)}
    dt.faiss_create("sqp", SQ_D, f"IVF{SQ_PLACE_NLIST},SQ8",
                    metric_type="INNER_PRODUCT", catalog=cat)
    dt.faiss_manual_train(corpus.chunk(0).cpu().numpy(), "sqp", catalog=cat)
    for i, n in corpus_chunks(SQ_PLACE_N):
        dt.faiss_add(corpus.chunk(i, n).cpu().numpy(), "sqp", catalog=cat)
    index = cat.get("sqp").index
    dt.set_precision("fast")
    lay = index._build_device_layout()
    check(index._layout_plan() == ("full", None), "sq placed: no full plan")
    t_setup = time.perf_counter() - t_phase
    ref = {b: dt.faiss_search("sqp", K, xq, params, catalog=cat)
           for b, xq in queries.items()}
    ref_walls = {b: walls_ms(lambda: dt.faiss_search("sqp", K, xq, params,
                                                     catalog=cat), reps=3)
                 for b, xq in queries.items()}
    del lay
    t0 = time.perf_counter()
    dt.faiss_to_device("sqp", make_mesh(PLACE_SHARDS), catalog=cat)
    index._build_sharded()
    t_place = time.perf_counter() - t0
    k2.TOPK_LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = 0
    out, paths = {}, {}
    for b, xq in queries.items():
        out[b] = dt.faiss_search("sqp", K, xq, params, catalog=cat)
        paths[b] = index._last_scan_path
    n = (k2.TOPK_LAUNCHES, k3.LAUNCHES)
    check(n == (PLACE_SHARDS, PLACE_SHARDS) and k2.LAUNCHES == 0,
          f"sq placed: (K2 fused, K3) launched {n} times")
    check(paths == {"b48": "per-query", "b1024": "pairs-sq8"},
          f"sq placed paths {paths}")
    check(np.array_equal(index._ids, np.arange(SQ_PLACE_N)),
          "sq placed: labels are not the storage rows")
    vmin, scale = index._sq_ranges(DEVICE)
    err, rescore_err, differ = 0.0, 0.0, 0
    for b, res in out.items():
        r, g = ref[b]["distance"], res["distance"]
        check(np.isfinite(g).all() and (res["label"] >= 0).all(),
              f"sq placed {b}: missing slots")
        tol = REL_TOL * float(np.abs(r).max())
        # every returned distance is its label's score from the decoded
        # codes, recomputed on the card in fp64
        codes = torch.from_numpy(index._codes[res["label"].reshape(-1)])
        rows = sq_decode(codes.to(DEVICE), vmin, scale, "sq8").double()
        want = (rows.view(*g.shape, SQ_D)
                * torch.from_numpy(queries[b]).to(DEVICE).double()[:, None]
                ).sum(-1).cpu().numpy()
        e = float(np.abs(g - want).max())
        check(e <= tol, f"sq placed {b}: a distance {e} off its label's "
              f"score from the codes (tolerance {tol})")
        rescore_err = max(rescore_err, e)
        check((g >= r - tol).all(), f"sq placed {b}: a placed rank worse "
              f"than the unplaced one")
        same = (np.abs(g - r) <= tol).all(1)
        differ += int((~same).sum())
        err = max(err, compare_same_k(f"sq placed {b}", res[same],
                                      ref[b][same], True))
    n_q = BATCH + BIG_BATCH
    check(differ <= SQ_PLACE_DIFFER_MAX * n_q, f"sq placed: {differ} of "
          f"{n_q} queries differ from the unplaced index")
    w = {b: walls_ms(lambda: dt.faiss_search("sqp", K, xq, params,
                                             catalog=cat), reps=3)
         for b, xq in queries.items()}
    loads = shard_loads(index)
    dt.set_precision("parity")
    log(f"phase 26 IVF{SQ_PLACE_NLIST},SQ8 {SQ_PLACE_N}x{SQ_D} IP nprobe "
        f"{SQ_NPROBE} fast mode placed {PLACE_SHARDS} ways (setup "
        f"{t_setup:.1f} s, sharded layout {t_place:.2f} s, lmax "
        f"{index._sharded_cache[2]}; per-shard Σcounts {loads}, max/mean "
        f"{max(loads) / np.mean(loads):.4f}): (K2 fused, K3) launches {n}; "
        f"every distance within {rescore_err:.3g} of its label's score "
        f"from the codes; no rank worse than unplaced, {differ} of {n_q} "
        f"queries better (wider int8 pools; at most "
        f"{SQ_PLACE_DIFFER_MAX:.0%} may be), the rest equal (max distance "
        f"error {err:.3g}); faiss_search wall b48 "
        f"{w['b48']:.3f} ms (unplaced {ref_walls['b48']:.3f}), b1024 "
        f"{w['b1024']:.3f} ms (unplaced {ref_walls['b1024']:.3f}) "
        f"({time.perf_counter() - t_phase:.1f} s) [{smi}]")
    return n, err


def marco_masks(smi, cat, index, data, params, db):
    """Phase 26, the device masks at the MS MARCO shape: phase 16's
    device-resident index filtered by id%2==0, its layout and spill masks
    built on the card (first call: the bitmap uploaded; again with the
    bitmap already there) and on the host (``host_row_mask`` and the
    upload); the searches equal both ways."""
    import duckdb_faiss_ext_tpu_torch as dt
    from duckdb_faiss_ext_tpu_torch.models import ivf_layout
    from duckdb_faiss_ext_tpu_torch.ops.selectors import host_row_mask

    ids = np.arange(MARCO_N, dtype=np.int64)
    sel = dt.create_mask((ids % 2 == 0).astype(np.uint8), ids)
    lay, sp = index._build_device_layout(), index._spill

    def build(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if device:
            masks = [index._row_mask(sel, lay.row_pos)]
            if sp is not None:
                masks.append(index._row_mask(sel, sp.pos))
        else:
            masks = [torch.from_numpy(host_row_mask(
                sel, index._ids, lay.row_pos_host)).to(DEVICE)]
            if sp is not None:
                masks.append(torch.from_numpy(host_row_mask(
                    sel, index._ids, sp.pos_host)).to(DEVICE))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), masks

    dev_first, dmasks = build(True)
    dev_again, _ = build(True)
    host_first, hmasks = build(False)
    host_again, _ = build(False)
    for a, b in zip(dmasks, hmasks):
        check(torch.equal(a, b), "marco masks: device and host masks differ")
    index._mask_cache.clear()
    with mask_paths() as seen:
        got = {b: dt.faiss_search("marco", K, data[b], params, catalog=cat,
                                  selector=sel) for b in ("b48", "b1024")}
    check(len(seen) == 1 + (sp is not None), f"marco masks: built {seen}")
    t0 = time.perf_counter()
    dt.faiss_search("marco", K, data["b48"], params, catalog=cat,
                    selector=sel)
    cached_ms = 1e3 * (time.perf_counter() - t0)
    saved = ivf_layout.device_row_mask
    ivf_layout.device_row_mask = lambda s_, rp, labels: torch.from_numpy(
        host_row_mask(s_, index._ids, rp.cpu().numpy())).to(rp.device)
    try:
        index._mask_cache.clear()
        want = {b: dt.faiss_search("marco", K, data[b], params, catalog=cat,
                                   selector=sel) for b in ("b48", "b1024")}
    finally:
        ivf_layout.device_row_mask = saved
    for b in got:
        for key in ("label", "distance"):
            check(np.array_equal(got[b][key], want[b][key]),
                  f"marco masks {b}: {key}s differ")
        check((got[b]["label"] % 2 == 0).all(), "marco masks: odd label")
    log(f"phase 26 device masks at {MARCO_N}x{SQ_D} (layout {SQ_NLIST} x "
        f"{lay.payload.shape[1]} slots, spill {sp.n if sp else 0} rows, "
        f"50% BitmapSelector of {sel.bitmap.nbytes} bytes): built on the "
        f"card {dev_first:.3f} ms at the first call (bitmap uploaded), "
        f"{dev_again:.3f} ms again; on the host (host_row_mask + upload) "
        f"{host_first:.3f} / {host_again:.3f} ms; filtered b48 with the "
        f"mask cached {cached_ms:.3f} ms wall; the search's masks: "
        f"{describe_masks(seen)}; b48 and b1024 filtered "
        f"results equal with either mask [{smi}]")


#: phase 27: the coded graph at the JAX package's round-0 marco settings
#: (logs/r5_chain7.log:4-20: sq4 build, deg 64, inter 64, lmax-factor 3.0,
#: no descent round, sq6 serving, width 4)
GRAPH27_ARGS = ["--deg", "64", "--inter", "64", "--lmax-factor", "3.0",
                "--half-k", "181", "--refine-rounds", "0", "--serve-codec",
                "sq6", "--width", "4", "--edge-sample", "1024"]
GRAPH27_POOLS = (64, 128)
#: rows of the walk held against the same walk over decoded fp32 rows
GRAPH27_PLAIN_N = 262_144


def phase_coded_graph(smi, marco):
    """Phase 27: the SQ-coded graph (ops/graph.py's coded paths through
    tools/marco_graph.py) over phase 16's 8,841,823 x 1536 corpus: the
    sq4 build's phases in seconds, the card's memory peak, membership
    coverage and the k-NN graph's edge recall, then the sq6 walk at b48
    and b1024, efSearch 64 / 128, recall@10 against phase 16's exact fp32
    labels, walls; every returned distance against fp64 from the codes;
    the coded walk over the first GRAPH27_PLAIN_N rows against the same
    walk over their decoded fp32 rows (labels equal, distances within
    1e-5 of the batch's largest)."""
    from duckdb_faiss_ext_tpu_torch.ops import graph as graph_ops
    from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu_torch.ops.sq import sq_decode, sq_unpack
    from duckdb_faiss_ext_tpu_torch.tools import marco_graph as mg

    dev = torch.device(DEVICE)
    args = mg.parse_args(GRAPH27_ARGS)
    corpus = marco_corpus()
    n = MARCO_N
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    built = mg.build(corpus, n, args, dev)
    knn = built.pop("knn")
    t0 = time.perf_counter()
    edge = mg.edge_recall(corpus, n, knn, args.edge_sample)
    t_edge = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = graph_ops.augment_graph(knn, args.deg)
    torch.cuda.synchronize()
    t_aug = time.perf_counter() - t0
    del knn, built["codes4"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    codes, vmin, scale = mg.serve_buffer(corpus, n, args.serve_codec, dev)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    secs = "; ".join(f"{k} {v:.1f} s" for k, v in built["seconds"].items())
    check(built["cells"] == args.half_k ** 2 and built["coverage"] > 0,
          f"coded graph: {built['cells']} cells, coverage "
          f"{built['coverage']}")
    log(f"coded graph {n}x{SQ_D} IP (sq4 build, deg {args.deg}, inter "
        f"{args.inter}, lmax-factor {args.lmax_factor}, "
        f"{args.refine_rounds} descent rounds): {secs}; augment_graph "
        f"{t_aug:.1f} s; sq6 encode {t_serve:.1f} s ({codes.numel() / 1e9:.2f}"
        f" GB); {built['cells']} cells, lmax {built['lmax']}, membership "
        f"coverage {built['coverage']:.4f} of the 2n entries, "
        f"{built['edgeless']} rows without a k-NN edge; edge recall "
        f"{edge:.4f} ({args.edge_sample} rows against their exact "
        f"{args.inter} nearest by K1, {t_edge:.1f} s); card memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")

    batches = {BATCH: marco["queries"]["b48"],
               BIG_BATCH: marco["queries"]["b1024"]}
    exact = {BATCH: marco["exact"]["b48"], BIG_BATCH: marco["exact"]["b1024"]}
    sweep = mg.sweep(codes, graph, n, batches, exact, GRAPH27_POOLS,
                     args.width, args.serve_codec, vmin, scale, k=K)
    s64, v64 = scale.double(), vmin.double()
    max_err = 0.0
    for (b, pool), (ms, rec) in sweep.items():
        dist, lab = mg.walk(codes, graph, batches[b], n, K, pool, args.width,
                            args.serve_codec, vmin, scale)
        check(lab.shape == (b, K) and bool((lab >= 0).all())
              and bool(torch.isfinite(dist).all()),
              f"coded walk b{b} ef={pool}: missing results")
        check(all(len(set(r)) == K for r in lab.cpu().numpy().tolist()),
              f"coded walk b{b} ef={pool}: a label repeats")
        rows = sq_unpack(codes[lab.reshape(-1).long()], args.serve_codec)
        rows = rows[:, :SQ_D].double() * s64 + v64
        q = torch.from_numpy(batches[b]).to(dev).double()
        ref = (rows.reshape(b, K, SQ_D) * q[:, None, :]).sum(-1)
        err = float((dist.double() - ref).abs().max())
        tol = REL_TOL * float(ref.abs().max())
        check(err <= tol, f"coded walk b{b} ef={pool}: distance error "
              f"{err} against fp64 from the codes, above {tol}")
        max_err = max(max_err, err)
        log(f"time coded walk b{b} ef={pool} width {args.width} (iterations "
            f"{graph_ops.default_iters(pool, args.width, args.deg)}): wall "
            f"{ms:.1f} ms (best of 3), recall@10 {rec:.4f} against exact "
            f"fp32 search over the {n} rows; distances within {err:.3g} "
            f"of fp64 from the codes [{smi}]")

    # The walk over the first GRAPH27_PLAIN_N rows: coded against decoded.
    m = GRAPH27_PLAIN_N
    sub = graph[:m].clone()
    sub[sub >= m] = -1
    dec = sq_decode(codes[:m], vmin, scale, args.serve_codec)
    for b, xq_np in batches.items():
        xq = torch.from_numpy(xq_np).to(dev)
        kw = dict(pool=max(GRAPH27_POOLS), width=args.width)

        def coded():
            return graph_ops.graph_search(
                codes[:m], sub, xq, m, K, "INNER_PRODUCT", codec=
                args.serve_codec, vmin=vmin, scale=scale, **kw)

        def plain():
            return graph_ops.graph_search(dec, sub, xq, m, K,
                                          "INNER_PRODUCT", rerank=True, **kw)

        cd, cl = finalize_scores(*coded(), "INNER_PRODUCT")
        pd, pl = finalize_scores(*plain(), "INNER_PRODUCT")
        check(torch.equal(cl, pl), f"coded walk b{b} over {m} rows: labels "
              f"differ from the walk over the decoded rows")
        err = float((cd - pd).abs().max())
        tol = REL_TOL * float(pd.abs().max())
        check(err <= tol, f"coded walk b{b} over {m} rows: distance error "
              f"{err} above {tol}")
        max_err = max(max_err, err)
        ms_c = statistics.median(cuda_ms(coded) for _ in range(3))
        ms_p = statistics.median(cuda_ms(plain) for _ in range(3))
        log(f"coded walk b{b} ef={kw['pool']} over the first {m} rows: "
            f"labels equal to the walk over the decoded fp32 rows, "
            f"distances within {err:.3g}; coded {ms_c:.1f} ms, decoded fp32 "
            f"{ms_p:.1f} ms (median CUDA events) [{smi}]")
    del dec, sub, graph, codes
    torch.cuda.empty_cache()
    log(f"phase 27: {time.perf_counter() - t_all:.1f} s; card memory peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return sweep, max_err


def main():
    t_script = time.perf_counter()
    smi = phase_environment()
    phase_build()
    sweep_err = phase_sweep()
    golden_err = phase_golden()
    data = main_path_data()
    main_err, launches, timings, exact = phase_main_path(smi, data)
    phase_time_1536(smi)
    err6, err7 = phase_ivf_sweep()
    err10 = phase_ivf_mega_sweep()
    ivf_err, ivf_err7, ivf_launches, ivf_timings, ivf = phase_ivf_main(
        smi, data, exact)
    phase_sql_harness(smi, data, ivf)
    torch.cuda.empty_cache()
    phase_port_bench(ivf["recall"])
    pq_sweep_err = phase_pq_sweep()
    pq = phase_pq_main(smi, data, exact)
    pq_spill_err = phase_pq_spill(pq, data)
    torch.cuda.empty_cache()
    rq_err = phase_rq_leg(smi, data, exact)
    torch.cuda.empty_cache()
    phase_pq_standalone(data)
    phase_sq_standalone(smi, data)
    phase_refine_pipeline(smi, data, exact)
    soar_cat = phase_imi_soar(smi, data, exact, ivf)
    phase_lsh(smi, data)
    phase_range(smi, data, ivf, pq, soar_cat)
    place, place_err = phase_placement(smi, data, exact, ivf, pq)
    del ivf, soar_cat, pq["cat"], pq["index"]
    graph_launches = phase_graph(smi, data, exact)
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
    phase_marco_refine(smi, sq)
    torch.cuda.empty_cache()
    sq_place, sq_place_err = phase_placement_sq(smi)
    torch.cuda.empty_cache()
    marco = phase_marco_device(smi)
    torch.cuda.empty_cache()
    phase_coded_graph(smi, marco)
    log(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s in all")
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
    # Phase 26's placed paths add their launches: K1, K6 / K7, K8 (1M x
    # 128) and K2 / K3 (IVF1024,SQ8 at d = 1536).
    print(json.dumps({"kernels": [
        kernel_entry(KERNEL, launches + graph_launches["k1"] + place["k1"],
                     max(sweep_err, golden_err, main_err, place_err),
                     *timings["b1024"]),
        kernel_entry(IVF_LIST_KERNEL,
                     ivf_launches + graph_launches["k6"] + place["k6"],
                     max(err6, ivf_err), k6_ms, k6_plain, k6_bound,
                     before_ms=k6_before_ms),
        kernel_entry(IVF_PAIRS_KERNEL,
                     pairs_launches + graph_launches["k7"] + place["k7"],
                     max(err7, ivf_err7, pairs_err), *pairs_timing,
                     before_ms=pairs_before),
        kernel_entry(SQ_LIST_KERNEL,
                     sq["launches"][0] + sq_place[0] + marco["trec"][0],
                     max(sq_errs[0], sq["err"][0], marco["k2"][1],
                         sq_place_err), k2_ms,
                     k2_plain, k2_bound, before_ms=k2_before_ms),
    ] + [
        kernel_entry(kernel, sq["launches"][i] + extra,
                     max(sq_errs[i], sq["err"][i]), *sq["timings"][key])
        for i, (kernel, key), extra in (
            (1, (SQ_PAIRS_KERNEL, "k3"), sq_place[1] + marco["trec"][1]),
            (2, (SQ_SPILL_KERNEL, "k5"), 0))
    ] + [
        kernel_entry(PQ_KERNEL, pq["launches"] + place["k8"],
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
