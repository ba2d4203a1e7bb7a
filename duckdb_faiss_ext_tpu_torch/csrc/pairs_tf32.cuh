// The 3xTF32 pair core of the fused pair-tile IVF,Flat searches for Hopper
// (sm_90a): K7 (ivf_pairs.cu, one block an item) and K10
// (ivf_pairs_mega.cu, persistent blocks fed by a TMA producer warp).  Both
// kernels stage the same chunks and call the same code below on them, so
// their candidates and results are bit-equal.
//
// Contract of the fused search (ops/ivf_pairs.py::ivf_pairs_search, the
// JAX package's pallas_ivf_pairs_search with its epilogue): lists (nlist,
// lmax, d) fp32 padded per list, counts (nlist,), row_pos (nlist, lmax),
// probe_ids (nq, nprobe), xq (nq, d), optional mask (nlist, lmax) bytes.
// For each query, the k2 = k_scan best live slots (row < count, mask byte
// not 0) of its probed lists by the expansion-form score (IP x.q, L2
// -max(|q|^2 - 2 x.q + |x|^2, 0)), ties to the lower flat index (probe
// slot * lmax + row): the pool; then the pool rescored exactly in fp32 in
// difference form (IP the elementwise dot, L2 -sum (x - q)^2), a lane a
// row summing in dimension order, sorted by that score with ties by pool
// order, and the k best written with their storage rows (row_pos), (-inf,
// -1) where missing.
//
// Work items (the wrapper builds their tables on the device, with no host
// round trip: ops/ivf_pairs.py::pair_items): the pairs (query, probe slot)
// sorted stably by list (order, as build_pair_tiles sorts them) and cut
// into runs of up to 8T pairs of one list (T tiles of 8 queries: the N
// operand); an item is a run times one share of the list's live rows
// (rows [share * S, min(count, (share + 1) * S))), so a list probed by up
// to 8T queries is read once a share, and a long list is cut into shares
// that run on different SMs.  Item slot c holds sorted pair first + c:
// query order / nprobe at probe slot order % nprobe.  The tables: order
// (npair,) int64; ends (2, nlist) int32, the inclusive prefix sums over
// the lists of their pairs and of their items; item_list (items,) the
// list of each item (a sorted search of ends[1]); head (4,) zeroed: the
// next-item counter (K10) and the largest |x|^2 (float bits).  The item
// count is ends[1][nlist - 1].

// The partial (per item, 8 consumer warps): row tiles of 128 rows walk
// the item's share; each row tile streams through a ring of stages in
// 32-dim chunks, the rows (M) beside the item's query rows (N), rows past
// the share never copied (zero-filled, K7) or left stale and never scored
// (K10's boxes); a warp holds 16 rows x 8T queries of fp32 accumulators
// and runs mma.sync m16n8k8 TF32 with the 3xTF32 split of flat_topk.cu
// (K1): each A fragment serves T N-fragments.  |x|^2 of each row and, on
// the first row tile, |q|^2 of each query come from the same staged
// chunks in fp32.  After a row tile's last chunk the scores are formed in
// registers, tested against each query's threshold, and the few that pass
// are appended to the query's list in shared memory (K1's pending-bit
// scheme, warp_topk.cuh's sort).  At the item's end each live query slot
// writes its k2 sorted (score, flat) candidates to part[(q * nprobe + j) *
// shares + share].
//
// The merge (a warp a query): the query's (probe slot, share) lists
// merged into the best k2 (the pool), their rows rescored exactly, sorted,
// resolved and written; the queries whose k-th exact score lies within
// twice the error bound E of the pool's last 3xTF32 score (K1's note:
// a slot outside the pool scores at most that plus E exactly) are counted
// into `unproven`, a diagnostic.
//
// Shared-memory layouts of a stage's rows: K7 and K10's cp.async instance
// keep a padded stride of 36 floats (conflict-free ldmatrix); K10's TMA
// boxes are dense 128-byte rows with the 128-byte swizzle (the 16-byte
// unit u of row r at u ^ (r % 8)).  The queries always take the padded
// stride.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "list_topk.cuh"
#include "warp_topk.cuh"

namespace ptf {

using wtk::better;
using wtk::kFull;
using wtk::kNoPos;
using wtk::push_sorted_lists;
using wtk::sort_used;
using wtk::TopK;

constexpr int kQG = 8;               // queries a tile: one N = 8 fragment
constexpr int kNT = 128;             // rows a row tile
constexpr int kDK = 32;              // dims a staged chunk
constexpr int kLD = kDK + 4;         // padded stride of a staged row, floats
constexpr int kThreads = 256;        // consumer threads: 8 warps x 16 rows
constexpr int kWarps = kThreads / 32;
constexpr int kTPR = kThreads / kNT;  // threads summing a row's |x|^2
constexpr int kDPT = kDK / kTPR;      // dims each of them sums a chunk

// The launch shape (ops/ivf_pairs.py::plan, in PLAN_FIELDS' order).
struct Plan {
  int nq, nprobe, nlist, lmax, d;
  int k, k2;            // results; candidates a (pair, share) list and the pool
  int tiles;            // T: tiles an item at most
  int share_rows;       // S, a multiple of kNT
  int shares;           // lists a pair: ceil(lmax / S)
  int items;            // items of any probe table at most
  int slots;            // a query slot's list in the partial: pow2 >= k2 + 64
  int stages;           // ring stages
  int merge_slots;      // the merge's list: pow2 >= max(2 k2, k2 + 32)
  int merge_warps;      // warps (queries) a merge block
  int smem, merge_smem;  // dynamic shared-memory bytes of the two launches
  int l2, vec4, tma;
};
constexpr int kPlanInts = 20;
static_assert(sizeof(Plan) == kPlanInts * sizeof(int), "Plan is kPlanInts ints");

__host__ inline Plan plan_from(const int* v) {
  Plan p;
  memcpy(&p, v, sizeof(Plan));
  return p;
}

struct Args {
  const float* lists;
  const int* counts;
  const int8_t* mask;
  const float* xq;
  const int64_t* order;   // (npair,) pairs sorted by list
  const int* ends;        // (2, nlist) prefix sums: pairs, items
  const int* item_list;   // (items,) list of each item
  int* head;              // next item (K10), largest |x|^2 bits
  float* part_s;
  int* part_p;
  Plan p;
};

struct MergeArgs {
  const float* lists;
  const int* counts;
  const int* row_pos;
  const int* probe_ids;
  const float* xq;
  const int* head;
  const float* part_s;
  const int* part_p;
  float* out_s;
  int* out_p;
  int* unproven;
  Plan p;
};

// --- items ---------------------------------------------------------------------

struct Item {
  int first, npairs;  // its sorted pairs: [first, first + npairs)
  int ntiles;         // ceil(npairs / 8)
  int lid, share;
  int r0, r1;         // the share's live rows of the list
  int nrt;            // row tiles
};

__device__ __forceinline__ int n_items(const Args& a) {
  return min(a.ends[2 * a.p.nlist - 1], a.p.items);
}

__device__ __forceinline__ Item item_at(const Args& a, int i) {
  const Plan& p = a.p;
  const int lid = min(max(a.item_list[i], 0), p.nlist - 1);
  const int u = i - (lid > 0 ? a.ends[p.nlist + lid - 1] : 0);
  const int start = lid > 0 ? a.ends[lid - 1] : 0;
  const int cnt = min(max(a.counts[lid], 0), p.lmax);
  const int shares = max(1, (cnt + p.share_rows - 1) / p.share_rows);
  const int run = u / shares, width = kQG * p.tiles;
  Item it;
  it.lid = lid;
  it.share = u - run * shares;
  it.first = start + run * width;
  it.npairs = min(width, a.ends[lid] - it.first);
  it.ntiles = (it.npairs + kQG - 1) / kQG;
  it.r0 = min(cnt, it.share * p.share_rows);
  it.r1 = min(cnt, it.r0 + p.share_rows);
  it.nrt = (it.r1 - it.r0 + kNT - 1) / kNT;
  return it;
}

// --- fragments -----------------------------------------------------------------

using ltk::smem_u32;

// x = hi + lo (3xTF32 split, as in flat_topk.cu): hi is x with its 13 low
// mantissa bits cleared, lo = x - hi exactly, read as TF32 by the tensor
// core.
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// ldmatrix of 8x8 b16 matrices read as 8 rows x 4 fp32: lane l gets row l /
// 4, word l % 4 of each matrix, the m16n8k8 TF32 fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Dims [c, c + 4) of staged row r (c a multiple of 4).
template <bool SWZ>
__device__ __forceinline__ const float* row_at(const float* xs, int r, int c) {
  if constexpr (SWZ) return xs + r * kDK + ((((c >> 2) ^ r) & 7) << 2);
  return xs + r * kLD + c;
}

// --- barriers among the consumer threads ----------------------------------------

struct BlockSync {  // every thread of the block consumes (K7)
  static __device__ __forceinline__ void sync() { __syncthreads(); }
  static __device__ __forceinline__ bool sync_or(bool v) { return __syncthreads_or(v) != 0; }
};

struct ConsumerSync {  // named barrier 1 over the consumer warps (K10)
  static __device__ __forceinline__ void sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  }
  static __device__ __forceinline__ bool sync_or(bool v) {
    int r;
    asm volatile(
        "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n bar.red.or.pred q, 1, %2, p;\n"
        " selp.s32 %0, 1, 0, q;\n}\n"
        : "=r"(r)
        : "r"(static_cast<int>(v)), "n"(kThreads)
        : "memory");
    return r != 0;
  }
};

// --- the consumer side of the partial ---------------------------------------------

// Bytes of the consumer state in shared memory for QT queries.
__host__ __device__ constexpr size_t lists_bytes(int qt, int slots) {
  return 4 * static_cast<size_t>(kTPR * kNT + kThreads + 6 * qt)
         + 8 * static_cast<size_t>(qt) * slots + kNT;
}

template <int T, bool SWZ, class Sync>
struct Core {
  static constexpr int QT = kQG * T;
  static constexpr int TPQ = kThreads / QT;  // threads summing a query's |q|^2
  static constexpr int QDPT = kDK / TPQ;     // dims each of them sums a chunk

  const Args& a;
  float* bnh;   // [kTPR][kNT] |x|^2 parts
  float* qnh;   // [TPQ][QT] |q|^2 parts
  float* qn;    // [QT]
  float* ts;    // [QT] thresholds
  int* tp;
  int* cnt;     // [QT] appended candidates
  int* qid;     // [QT] query of each slot, -1 dead
  int* pj;      // [QT] its probe slot
  float* top_s;  // [QT][slots]
  int* top_p;
  int8_t* valid;  // [kNT]
  int ct, lane, warp, g, t4;
  float acc[T][4];
  float bn_part, qn_part, bn_hi;

  __device__ Core(const Args& args, uint8_t* smem, int tid) : a(args) {
    const int slots = a.p.slots;
    bnh = reinterpret_cast<float*>(smem);
    qnh = bnh + kTPR * kNT;
    qn = qnh + kThreads;
    ts = qn + QT;
    tp = reinterpret_cast<int*>(ts + QT);
    cnt = tp + QT;
    qid = cnt + QT;
    pj = qid + QT;
    top_s = reinterpret_cast<float*>(pj + QT);
    top_p = reinterpret_cast<int*>(top_s + QT * slots);
    valid = reinterpret_cast<int8_t*>(top_p + QT * slots);
    ct = tid;
    lane = tid & 31;
    warp = tid >> 5;
    g = lane >> 2;
    t4 = lane & 3;
    bn_hi = 0.f;
  }

  // The item's query slots and empty lists.
  __device__ void begin(const Item& it) {
    const int k2 = a.p.k2, slots = a.p.slots;
    for (int qq = warp; qq < QT; qq += kWarps) {
      if (lane == 0) {
        int q = -1, j = 0;
        if (qq < it.npairs) {
          const int64_t pair = a.order[it.first + qq];
          q = static_cast<int>(pair / a.p.nprobe);
          j = static_cast<int>(pair - static_cast<int64_t>(q) * a.p.nprobe);
        }
        qid[qq] = q;
        pj[qq] = j;
        ts[qq] = -INFINITY;
        tp[qq] = kNoPos;
        cnt[qq] = 0;
      }
      for (int i = lane; i < k2; i += 32) {
        top_s[qq * slots + i] = -INFINITY;
        top_p[qq * slots + i] = kNoPos;
      }
    }
    bn_part = qn_part = 0.f;
    Sync::sync();
  }

  // On a row tile's first chunk: its rows' validity, and zero sums.
  __device__ void tile_begin(const Item& it, int rt) {
    if (ct < kNT) {
      const int row = it.r0 + rt * kNT + ct;
      valid[ct] = row < it.r1 &&
                  (a.mask == nullptr ||
                   a.mask[static_cast<int64_t>(it.lid) * a.p.lmax + row] != 0);
    }
#pragma unroll
    for (int nt = 0; nt < T; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  }

  // One staged chunk: rows xs (kNT of them), queries qs (QT rows, kLD apart).
  __device__ void chunk(const float* xs, const float* qs, int ntl, bool first_rt) {
    const int lm = lane >> 3, lr = lane & 7;  // the matrix and row this lane names
#pragma unroll
    for (int kk = 0; kk < kDK; kk += 8) {
      uint32_t ah[4], al[4], bh[T][2], bl[T][2];
      {
        // matrices: rows +0 / +8 (bit 0) x dims +0 / +4 (bit 1) = a0..a3
        uint32_t v[4];
        ldsm_x4(v, row_at<SWZ>(xs, warp * 16 + lr + 8 * (lm & 1), kk + 4 * (lm >> 1)));
#pragma unroll
        for (int j = 0; j < 4; ++j) split(v[j], ah[j], al[j]);
      }
      if constexpr (T % 2 == 0) {
#pragma unroll
        for (int nt = 0; nt < T; nt += 2) {
          // matrices: dims +0 / +4 (bit 0) x query tiles nt / nt + 1 (bit 1)
          uint32_t v[4];
          ldsm_x4(v, qs + ((nt + (lm >> 1)) * kQG + lr) * kLD + kk + 4 * (lm & 1));
          split(v[0], bh[nt][0], bl[nt][0]);
          split(v[1], bh[nt][1], bl[nt][1]);
          split(v[2], bh[nt + 1][0], bl[nt + 1][0]);
          split(v[3], bh[nt + 1][1], bl[nt + 1][1]);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < T; ++nt) {
          uint32_t v[2];
          ldsm_x2(v, qs + (nt * kQG + lr) * kLD + kk + 4 * (lm & 1));
          split(v[0], bh[nt][0], bl[nt][0]);
          split(v[1], bh[nt][1], bl[nt][1]);
        }
      }
      // Product-major order, as in K1; tiles past the item's are skipped.
#pragma unroll
      for (int nt = 0; nt < T; ++nt)
        if (nt < ntl) mma_tf32(acc[nt], ah, bl[nt]);
#pragma unroll
      for (int nt = 0; nt < T; ++nt)
        if (nt < ntl) mma_tf32(acc[nt], al, bh[nt]);
#pragma unroll
      for (int nt = 0; nt < T; ++nt)
        if (nt < ntl) mma_tf32(acc[nt], ah, bh[nt]);
    }
    {  // |x|^2: kDPT dims of row ct % kNT a chunk
      const int row = ct % kNT, sub = ct / kNT;
#pragma unroll
      for (int j = 0; j < kDPT / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(row_at<SWZ>(xs, row, kDPT * sub + 4 * j));
        bn_part = fmaf(v.x, v.x, bn_part);
        bn_part = fmaf(v.y, v.y, bn_part);
        bn_part = fmaf(v.z, v.z, bn_part);
        bn_part = fmaf(v.w, v.w, bn_part);
      }
    }
    if (first_rt) {  // |q|^2: QDPT dims of query ct / TPQ a chunk
      const float* qr = qs + (ct / TPQ) * kLD + (ct % TPQ) * QDPT;
#pragma unroll
      for (int e = 0; e < QDPT; ++e) qn_part = fmaf(qr[e], qr[e], qn_part);
    }
  }

  // After a row tile's last chunk: scores in registers, threshold test,
  // append; a score that finds its query's buffer full stays pending, the
  // full lists are sorted (raising their thresholds) and the pending
  // scores tried again.
  __device__ void tile_end(const Item& it, int rt) {
    const int k2 = a.p.k2, slots = a.p.slots, buf = slots - k2, lmax = a.p.lmax;
    const int l2 = a.p.l2;
    bnh[(ct / kNT) * kNT + ct % kNT] = bn_part;
    bn_part = 0.f;
    if (rt == 0) {
      qnh[(ct % TPQ) * QT + ct / TPQ] = qn_part;
      qn_part = 0.f;
    }
    Sync::sync();
    if (rt == 0) {
      if (ct < QT) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < TPQ; ++p) s += qnh[p * QT + ct];
        qn[ct] = s;
      }
      Sync::sync();
    }
    const int ntl = it.ntiles;
    const int row0 = it.r0 + rt * kNT;
    float bn_r[2];
    uint32_t pending = 0;  // bit nt * 4 + i: fragment entry still to append
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = warp * 16 + g + 8 * h;
      float bn = 0.f;
#pragma unroll
      for (int s = 0; s < kTPR; ++s) bn += bnh[s * kNT + rl];
      bn_r[h] = bn;
      if (!valid[rl]) continue;
#pragma unroll
      for (int nt = 0; nt < T; ++nt)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq)
          if (nt < ntl && qid[nt * kQG + 2 * t4 + hq] >= 0)
            pending |= 1u << (nt * 4 + 2 * h + hq);
    }
    if (ct < kNT && valid[ct]) {
      float bn = 0.f;
#pragma unroll
      for (int s = 0; s < kTPR; ++s) bn += bnh[s * kNT + ct];
      bn_hi = fmaxf(bn_hi, bn);
    }
    while (true) {
      if (pending) {
        float qn_q[T][2], ts_q[T][2];
        int tp_q[T][2], pj_q[T][2];
#pragma unroll
        for (int nt = 0; nt < T; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ql = nt * kQG + 2 * t4 + h;
            qn_q[nt][h] = qn[ql];
            ts_q[nt][h] = ts[ql];
            tp_q[nt][h] = tp[ql];
            pj_q[nt][h] = pj[ql];
          }
#pragma unroll
        for (int nt = 0; nt < T; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t bit = 1u << (nt * 4 + i);
            if (!(pending & bit)) continue;
            const int hr = i >> 1, hq = i & 1;
            const float dot = acc[nt][i];
            const float sc = l2 ? -fmaxf(qn_q[nt][hq] - 2.f * dot + bn_r[hr], 0.f) : dot;
            const int flat = pj_q[nt][hq] * lmax + row0 + warp * 16 + g + 8 * hr;
            if (better(sc, flat, ts_q[nt][hq], tp_q[nt][hq])) {
              const int ql = nt * kQG + 2 * t4 + hq;
              const int at = atomicAdd(cnt + ql, 1);
              if (at >= buf) continue;  // full: stays pending
              top_s[ql * slots + k2 + at] = sc;
              top_p[ql * slots + k2 + at] = flat;
            }
            pending &= ~bit;
          }
      }
      if (!Sync::sync_or(pending != 0)) break;
      for (int qq = warp; qq < QT; qq += kWarps) {
        if (cnt[qq] < buf) continue;  // warp-uniform
        float* s = top_s + qq * slots;
        int* p = top_p + qq * slots;
        sort_used(s, p, k2 + buf, lane);
        if (lane == 0) {
          ts[qq] = s[k2 - 1];
          tp[qq] = p[k2 - 1];
          cnt[qq] = 0;
        }
      }
      Sync::sync();
    }
  }

  // The item's end: each live query slot's k2 best, sorted, to its list.
  __device__ void end(const Item& it) {
    const int k2 = a.p.k2, slots = a.p.slots, buf = slots - k2;
    for (int qq = warp; qq < QT; qq += kWarps) {
      const int q = qid[qq];
      if (q < 0) continue;  // warp-uniform
      float* s = top_s + qq * slots;
      int* p = top_p + qq * slots;
      const int c = min(cnt[qq], buf);
      if (c > 0) sort_used(s, p, k2 + c, lane);
      const int64_t base =
          ((static_cast<int64_t>(q) * a.p.nprobe + pj[qq]) * a.p.shares + it.share) * k2;
      for (int t = lane; t < k2; t += 32) {
        a.part_s[base + t] = s[t];
        a.part_p[base + t] = p[t];
      }
    }
    Sync::sync();
  }

  // The block's largest |x|^2 over the valid rows it scored (non-negative:
  // int order) into head[1].
  __device__ void flush_bn() {
    if (warp < kNT / 32) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        bn_hi = fmaxf(bn_hi, __shfl_xor_sync(kFull, bn_hi, off));
      if (lane == 0) atomicMax(a.head + 1, __float_as_int(bn_hi));
    }
  }
};

// --- (b) the merge --------------------------------------------------------------

// The bound E of flat_topk.cu's note for one query: |3xTF32 score - fp32
// score| for a query of squared norm qn against rows of squared norm at
// most bn_hi (the same formula as K1's error_bound).
__device__ __forceinline__ float error_bound(float qn, float bn_hi, int d, int l2) {
  const float u = 5.9604645e-8f;  // 2^-24
  const float eps = 3.01f * 16.f * u + 3.f * ((d + 7) / 8) * 4.f * u + d * u;
  const float s = sqrtf(qn) * sqrtf(bn_hi) * 1.001f;
  return l2 ? 2.f * s * eps + (2.f * d + 4.f) * u * (qn + bn_hi) + 8.f * u * s : s * eps;
}

// One warp: query q's pool, rescore, sort, resolve, write.  s, p, f are
// the warp's merge_slots-slot lists in shared memory.
__device__ inline void merge_query(const MergeArgs& a, float* s, int* p, int* f, int q, int lane) {
  const Plan& pl = a.p;
  const int k2 = pl.k2, lmax = pl.lmax, d = pl.d;
  TopK top;
  top.init(s, p, k2, pl.merge_slots, lane);
  for (int j = 0; j < pl.nprobe; ++j) {
    const int lid = a.probe_ids[static_cast<int64_t>(q) * pl.nprobe + j];
    if (lid < 0 || lid >= pl.nlist) continue;
    const int cnt = min(max(a.counts[lid], 0), lmax);
    if (cnt == 0) continue;
    const int64_t at = (static_cast<int64_t>(q) * pl.nprobe + j) * pl.shares * k2;
    push_sorted_lists(top, a.part_s + at, a.part_p + at,
                      (cnt + pl.share_rows - 1) / pl.share_rows, lane, k2);
  }
  if (top.cnt > 0) top.flush(lane);
  const float a_last = s[k2 - 1];
  const bool full = p[k2 - 1] != kNoPos;

  const float* qrow = a.xq + static_cast<int64_t>(q) * d;
  float qn = 0.f;
  for (int c = lane; c < d; c += 32) qn = fmaf(qrow[c], qrow[c], qn);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(kFull, qn, off);
  __syncwarp();
  for (int i = lane; i < k2; i += 32) f[i] = p[i];
  __syncwarp();
  // Exact fp32 rescore, a lane a row, each sum in dimension order.
  for (int i = lane; i < k2; i += 32) {
    const int flat = f[i];
    float sc = -INFINITY;
    if (flat != kNoPos) {
      const int slot = flat / lmax;
      const int lid = a.probe_ids[static_cast<int64_t>(q) * pl.nprobe + slot];
      const float* x = a.lists + (static_cast<int64_t>(lid) * lmax + flat - slot * lmax) * d;
      float acc = 0.f;
      if (pl.vec4) {
        for (int c = 0; c < d; c += 4) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(x + c));
          const float4 qv = __ldg(reinterpret_cast<const float4*>(qrow + c));
          if (pl.l2) {
            float t = xv.x - qv.x;
            acc = fmaf(t, t, acc);
            t = xv.y - qv.y;
            acc = fmaf(t, t, acc);
            t = xv.z - qv.z;
            acc = fmaf(t, t, acc);
            t = xv.w - qv.w;
            acc = fmaf(t, t, acc);
          } else {
            acc = fmaf(xv.x, qv.x, acc);
            acc = fmaf(xv.y, qv.y, acc);
            acc = fmaf(xv.z, qv.z, acc);
            acc = fmaf(xv.w, qv.w, acc);
          }
        }
      } else {
        for (int c = 0; c < d; ++c) {
          const float xc = __ldg(x + c), qc = __ldg(qrow + c);
          if (pl.l2) {
            const float t = xc - qc;
            acc = fmaf(t, t, acc);
          } else {
            acc = fmaf(xc, qc, acc);
          }
        }
      }
      sc = pl.l2 ? -acc : acc;
    }
    s[i] = sc;
    p[i] = i;  // pool order: the tie rule of exact_topk over the pool
  }
  __syncwarp();
  sort_used(s, p, k2, lane);
  for (int t = lane; t < pl.k; t += 32) {
    const float sc = s[t];
    const int idx = p[t];
    const int flat = idx < k2 ? f[idx] : kNoPos;
    const bool missing = flat == kNoPos || sc == -INFINITY;
    int pos = -1;
    if (!missing) {
      const int slot = flat / lmax;
      const int lid = a.probe_ids[static_cast<int64_t>(q) * pl.nprobe + slot];
      pos = a.row_pos[static_cast<int64_t>(lid) * lmax + flat - slot * lmax];
    }
    a.out_s[static_cast<int64_t>(q) * pl.k + t] = missing ? -INFINITY : sc;
    a.out_p[static_cast<int64_t>(q) * pl.k + t] = pos;
  }
  const float e_k = s[pl.k - 1];
  if (lane == 0 && full && e_k > -INFINITY &&
      a_last >= e_k - 2.f * error_bound(qn, __int_as_float(a.head[1]), d, pl.l2))
    atomicAdd(a.unproven, 1);
}

// The merge launch's body: a warp a query, no block barrier.
__device__ inline void merge(const MergeArgs& a) {
  extern __shared__ __align__(16) unsigned char msmem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * warps + warp;
  if (q >= a.p.nq) return;
  const int ms = a.p.merge_slots;
  float* s = reinterpret_cast<float*>(msmem) + 3 * warp * ms;
  int* p = reinterpret_cast<int*>(s + ms);
  int* f = p + ms;
  merge_query(a, s, p, f, q, lane);
}

}  // namespace ptf
