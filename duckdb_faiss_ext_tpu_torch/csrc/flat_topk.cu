// Fused L2 / inner-product distance + exact top-k over a flat corpus, for
// Hopper (sm_90a).  Replaces the TPU kernel
// duckdb_faiss_ext_tpu/ops/pallas_topk.py::_topk_kernel; the Python wrapper
// is duckdb_faiss_ext_tpu_torch/ops/flat_topk.py.
//
// Contract: for each query q, the k corpus rows r < n_scan (and with
// mask[r] != 0 when a mask is given) with the best max-oriented score,
//   IP: q·x        L2: -max(|q|^2 - 2 q·x + |x|^2, 0)
// sorted score descending, then position ascending.  Missing slots are
// (-inf, -1).  The returned scores are fp32 FMA sums.
//
// What bounds it on the H100: at b1024 over 1M x 128 the 2.6e11 operations,
// 3.91 ms in fp32 FMA (67 TFLOP/s) but 1.59 ms on the TF32 tensor cores
// with three products each (495 / 3 TFLOP/s); at b48 (64 rows) reading the
// corpus, 512 MB = 0.153 ms.  So the dot products run on the tensor cores
// and the fp32 answer comes from a rescore of a few candidates.
//
// Design.  Two launches (GPU blocks run in parallel and in no order, so the
// TPU kernel's top-k carried across a sequential grid axis becomes a split
// and a merge):
//   (a) flat_topk_partial: grid = query tiles x corpus splits.  Corpus
//       tiles of 256 rows (128 beside fewer than 32 queries) and the
//       block's QT queries stream through a 3-stage cp.async ring in 32-dim
//       chunks (the queries stream too: at d = 1536 a query tile's hi / lo
//       halves would not fit beside the corpus); a thread's copies keep
//       fixed offsets, and the ring's positions advance without a
//       division.  Eight warps, each with up to 64 rows x 32 queries of
//       accumulators, load fragments with ldmatrix and run mma.sync
//       m16n8k8 TF32 with the 3xTF32 split: hi = tf32(a), lo = a - hi, and
//       the product is hi·lo + lo·hi + hi·hi accumulated in fp32 (the rows
//       are the M operand, the queries N: both row-major, so both
//       K-major).  |x|^2 of
//       each row comes from the same staged chunks in fp32.  The L2
//       expansion, the row mask and nvalid are applied to the accumulator
//       fragment in registers; each score is compared with its query's
//       threshold, and only the few that pass are appended (a shared-memory
//       atomic) to the query's candidate buffer.  A score that finds the
//       buffer full stays pending in a per-thread bit mask; then a warp
//       sorts each full list (bitonic), which raises its threshold, and the
//       pending scores are tried again, so a buffer needs no room for a
//       whole tile (64 slots beside K2) and the block keeps one barrier a
//       tile once the thresholds settle.  Each query keeps K2 = k + m
//       candidates per split, sorted by the 3xTF32 score then position.
//   (b) flat_topk_merge: a warp per query merges the splits' sorted lists
//       into the best K2 (stopping on a list at the first 32 entries that
//       fail the threshold), rescores those K2 rows exactly in fp32 FMA,
//       a lane a row summing in dimension order (qn - 2 q·x + bn clamped
//       at 0; IP q·x), sorts them by that score then position, and writes
//       k.
//
// The dense regime, for a small corpus (the IVF coarse stage over a
// centroid table: 2048 x 1536 gave the split 8 blocks on 132 SMs, each
// sorting its one tile's candidates through the bitonic warm-up, and a
// merge whose lanes read 6 KB rows apart).  ops/flat_topk.py::plan picks
// it from the shape (at most 32,768 rows, a score tile of at most 64 MB):
//   (c) flat_topk_dense: grid = query tiles x row tiles of 64 x 128,
//       32 x 32 or 16 x 32 (4 warps), the largest that still gives a wave
//       of blocks; the partial's staging, products and |x|^2 (its threads
//       a row, from the split plan's query tile) unchanged, so every
//       3xTF32 score is the split's bit for bit.  The epilogue writes the
//       (nq, n_scan) score tile (in L2: 0.5 MB at 64 x 2048) and each row
//       tile's largest valid |x|^2; no threshold, no candidate list.
//   (d) flat_topk_select: a block per query takes the best K2 of its
//       valid scores by (score descending, position ascending) with a
//       radix select over the scores' order keys (8 bits a pass, histograms
//       in shared memory; exact ties at the K2-th key resolved by
//       position), which is the set (a) and (b) keep; rescores them as (b)
//       does, each sum in dimension order, over rows staged through shared
//       memory in coalesced chunks; and ends as (b) ends.  So both regimes
//       return the same bits.
//
// Choice of m.  With u = 2^-24 and a the query, b a row:
//   hi = tf32 truncation of a: |a - hi| < 2^-10 |a|; lo = a - hi (exact),
//   read as TF32 by truncation: |lo - tf32(lo)| < 2^-10 |lo| < 2^-20 |a|;
//   so the three products drop lo_a·lo_b and the truncations of lo, at
//   most 3.01 · 2^-20 |a||b| a term (c·2^-21 with c = 6.02; rounding to
//   nearest instead would give 3.01 · 2^-22).  TF32 products are exact in
//   fp32; the tensor core's fp32 accumulation is taken at 2 ulps (2^-22) of the
//   running sum for each of the 3·ceil(d/8) mma steps, and the rescore's d
//   FMAs at u each.  With S = Σ|q_i||x_i| <= |q| max|x| (Cauchy-Schwarz):
//     |approx - exact| <= S · eps_d,
//     eps_d = 3.01 · 2^-20 + 3 ceil(d/8) · 2^-22 + d u
//   (2.2e-5 at d = 128, 2.3e-4 at d = 1536).  L2 doubles it and adds the
//   two sums of squares taken in another order and the epilogue's three
//   roundings: E = 2 S eps_d + (2d + 4) u (|q|^2 + max|x|^2) + 8 u S.
//   A row outside the final K2 candidates scores at most a_K2 (the K2-th
//   candidate's 3xTF32 score) in 3xTF32, so at most a_K2 + E exactly; the
//   k-th exact score e_k is proven whenever a_K2 < e_k - 2E (the second E
//   covers the plain version's own fp32 rounding).  The rows within 2E of
//   the k-th score number about k · 2E · z / sigma in a Gaussian tail (z
//   the k-th score's standard score, sigma the score spread): 0.8 at 1M x
//   1536 IP k = 10, far less at d = 128; m = max(16, k / 8) leaves that
//   count far behind.  The merge counts the queries where a_K2 >= e_k - 2E
//   (unproven; duplicated rows that tie are among them) into `unproven`, a
//   diagnostic: the result is the same either way.
//
// The tile skip of the TPU kernel is the threshold test itself: a warp
// whose fragment holds no passing score appends nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "warp_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDK = 32;          // dims per staged chunk
constexpr int kLD = kDK + 4;     // staged row stride: conflict-free fragment loads
constexpr int kStages = 3;

using wtk::better;
using wtk::kFull;
using wtk::kNoPos;
using wtk::push_sorted_lists;
using wtk::sort_used;
using wtk::TopK;

// x = hi + lo (3xTF32 split): hi is x truncated to TF32 (its 13 low
// mantissa bits cleared), lo = x - hi exactly, which the tensor core reads
// as TF32 by dropping its own 13 low bits.  Two integer / fp32 operations,
// where cvt.rna.tf32.f32 runs on the slower conversion pipe.
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// ldmatrix of 8x8 b16 matrices read as 8 rows x 4 fp32: lane l gets row
// l / 4, word l % 4 of each matrix, the m16n8k8 TF32 fragment layout.  Lane
// l names row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(cpa::smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(cpa::smem_addr(row)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ constexpr int tile_rows(int qt) { return qt >= 32 ? 256 : 128; }

// A block's tile: QT queries x NT corpus rows, kWarps warps; WN warps
// along the queries, WM along the rows; each warp holds MT x NQ fragments of 16
// rows x 8 queries.  Every tile starts at a multiple of 16 rows and 8
// queries, so a (row, query) pair sits at the same fragment place in every
// tile shape.
template <int QT_, int NT_, int WN_>
struct Tile {
  static constexpr int QT = QT_, NT = NT_, WN = WN_;
  static constexpr int WM = kWarps / WN;
  static constexpr int MW = NT / WM;      // rows a warp
  static constexpr int QW = QT / WN;      // queries a warp
  static constexpr int MT = MW / 16;
  static constexpr int NQ = QW / 8;
  static constexpr int RS = kThreads / 8;  // rows one round of 16-byte copies covers
  static_assert(MW % 16 == 0 && QW % 8 == 0 && NT % RS == 0, "tile shape");
};

// The partial's tile of a query tile of QT: 256 corpus rows beside 32 or 64
// queries, 128 beside fewer.
template <int QT>
using Layout = Tile<QT, tile_rows(QT), QT >= 16 ? 2 : 1>;

// The dense regime's score tiles, largest first (ops/flat_topk.py's
// _DENSE_TILES names them by index).
using DenseWide = Tile<64, 128, 2>;
using DenseSquare = Tile<32, 32, 4>;

// Shared-memory bytes of flat_topk_partial<QT> with `slots` a query.
__host__ __device__ constexpr size_t partial_smem(int qt, int slots) {
  return sizeof(float) * kStages * (tile_rows(qt) + qt) * kLD  // the ring
         + sizeof(float) * kThreads + tile_rows(qt)           // |x|^2 parts, row validity
         + 16 * static_cast<size_t>(qt)                       // qn, ts, tp, cnt
         + 8 * static_cast<size_t>(qt) * slots;               // candidate lists
}

// |q|^2 of one query row by a warp: lane-strided fp32 FMA sums, then a
// butterfly; every lane returns it.
__device__ __forceinline__ float query_norm(const float* qrow, int d, int lane) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = lane; c < d; c += 32) acc = fmaf(qrow[c], qrow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// Into one stage of the ring: corpus rows [t0, t0 + NT) below r_end and
// queries [q0, q0 + QT) below nq, dims [c0, c0 + kDK); the rest zero-filled.
template <class L, bool VEC4>
__device__ __forceinline__ void stage_chunk(float* st, const float* __restrict__ xb,
                                            const float* __restrict__ xq, int64_t t0,
                                            int64_t r_end, int q0, int nq, int d, int c0,
                                            int tid) {
  constexpr int NT = L::NT, QT = L::QT;
  if (VEC4) {
    // A thread copies 16 bytes (dims c4 .. c4 + 3) of rows r0, r0 + RS,
    // ...: corpus rows, then query rows past NT.
    const int r0 = tid >> 3, c4 = (tid & 7) * 4;
    const bool dims = c0 + c4 < d;
    const float* rows = xb + (t0 + r0) * d + c0 + c4;
#pragma unroll
    for (int j = 0; j < (NT + QT + L::RS - 1) / L::RS; ++j) {
      const int rr = r0 + L::RS * j;
      const float* src = xb;
      int bytes = 0;
      if (L::RS * j < NT) {
        if (t0 + rr < r_end && dims) { src = rows + static_cast<int64_t>(L::RS * j) * d; bytes = 16; }
      } else {
        if (rr >= NT + QT) continue;
        if (q0 + rr - NT < nq && dims) {
          src = xq + static_cast<int64_t>(q0 + rr - NT) * d + c0 + c4;
          bytes = 16;
        }
      }
      cpa::copy16(st + rr * kLD + c4, src, bytes);
    }
  } else {
    for (int i = tid; i < (NT + QT) * kDK; i += kThreads) {
      const int rr = i / kDK, cc = i % kDK;
      const float* src = xb;
      int bytes = 0;
      if (rr < NT) {
        if (t0 + rr < r_end && c0 + cc < d) { src = xb + (t0 + rr) * d + c0 + cc; bytes = 4; }
      } else if (q0 + rr - NT < nq && c0 + cc < d) {
        src = xq + static_cast<int64_t>(q0 + rr - NT) * d + c0 + cc;
        bytes = 4;
      }
      cpa::copy4(st + rr * kLD + cc, src, bytes);
    }
  }
}

// The 3xTF32 products of one staged chunk (rows xs, queries qsm) into a
// warp's accumulators.
template <class L>
__device__ __forceinline__ void mma_chunk(float (&acc)[L::MT][L::NQ][4], const float* xs,
                                          const float* qsm, int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kDK; kk += 8) {
    uint32_t ah[L::MT][4], al[L::MT][4], bh[L::NQ][2], bl[L::NQ][2];
    const int lm = lane >> 3, lr = lane & 7;  // the matrix and row this lane names
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) {
      // matrices: rows +0 / +8 (bit 0) x dims +0 / +4 (bit 1) = a0..a3
      uint32_t v[4];
      ldsm_x4(v, xs + (wm * L::MW + mt * 16 + lr + 8 * (lm & 1)) * kLD + kk + 4 * (lm >> 1));
#pragma unroll
      for (int j = 0; j < 4; ++j) split(v[j], ah[mt][j], al[mt][j]);
    }
    if constexpr (L::NQ % 2 == 0) {
#pragma unroll
      for (int nt = 0; nt < L::NQ; nt += 2) {
        // matrices: dims +0 / +4 (bit 0) x query tiles nt / nt + 1 (bit 1)
        uint32_t v[4];
        ldsm_x4(v, qsm + (wn * L::QW + (nt + (lm >> 1)) * 8 + lr) * kLD + kk + 4 * (lm & 1));
        split(v[0], bh[nt][0], bl[nt][0]);
        split(v[1], bh[nt][1], bl[nt][1]);
        split(v[2], bh[nt + 1][0], bl[nt + 1][0]);
        split(v[3], bh[nt + 1][1], bl[nt + 1][1]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < L::NQ; ++nt) {
        uint32_t v[2];
        ldsm_x2(v, qsm + (wn * L::QW + nt * 8 + lr) * kLD + kk + 4 * (lm & 1));
        split(v[0], bh[nt][0], bl[nt][0]);
        split(v[1], bh[nt][1], bl[nt][1]);
      }
    }
    // Product-major order: the three products of one accumulator are
    // MT·NQ independent mma apart, so none waits on the one before.
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NQ; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NQ; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NQ; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
  }
}

// A thread's share of one staged row's |x|^2 over a chunk: dims
// [dpt · sub, dpt · (sub + 1)) in order, added to acc.
__device__ __forceinline__ float row_norm_part(const float* xs, int row, int sub, int dpt,
                                               float acc) {
  const float4* xr = reinterpret_cast<const float4*>(xs + row * kLD + dpt * sub);
#pragma unroll 8
  for (int j = 0; j < dpt / 4; ++j) {
    const float4 v = xr[j];
    acc = fmaf(v.x, v.x, acc);
    acc = fmaf(v.y, v.y, acc);
    acc = fmaf(v.z, v.z, acc);
    acc = fmaf(v.w, v.w, acc);
  }
  return acc;
}

template <int QT, bool VEC4>
__global__ void __launch_bounds__(kThreads, 1)
flat_topk_partial(const float* __restrict__ xb, const float* __restrict__ xq,
                  const int8_t* __restrict__ mask, int nq, int d,
                  int64_t n_scan, int64_t rows_per_split, int k2, int slots,
                  int l2, float* __restrict__ part_s, int* __restrict__ part_p,
                  float* __restrict__ bn_max) {
  using L = Layout<QT>;
  constexpr int NT = L::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);                // [stage][NT + QT][kLD]
  float* bnh_s = ring + kStages * (NT + QT) * kLD;              // [TPR][NT]
  float* qn_s = bnh_s + kThreads;                               // [QT]
  float* ts_s = qn_s + QT;                                      // [QT]
  int* tp_s = reinterpret_cast<int*>(ts_s + QT);                // [QT]
  int* cnt_s = tp_s + QT;                                       // [QT]
  float* top_s = reinterpret_cast<float*>(cnt_s + QT);          // [QT][slots]
  int* top_p = reinterpret_cast<int*>(top_s + QT * slots);      // [QT][slots]
  int8_t* valid_s = reinterpret_cast<int8_t*>(top_p + QT * slots);  // [NT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % L::WM, wn = warp / L::WM;
  const int q0 = blockIdx.x * QT;
  const int split_id = blockIdx.y, splits = gridDim.y;
  const int64_t r_begin = static_cast<int64_t>(split_id) * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n_scan ? r_begin + rows_per_split : n_scan;
  const int buf = slots - k2;

  for (int qq = warp; qq < QT; qq += kWarps) {
    const float qn =
        l2 && q0 + qq < nq ? query_norm(xq + static_cast<int64_t>(q0 + qq) * d, d, lane) : 0.f;
    if (lane == 0) {
      qn_s[qq] = qn;
      ts_s[qq] = -INFINITY;
      tp_s[qq] = kNoPos;
      cnt_s[qq] = 0;
    }
    for (int i = lane; i < k2; i += 32) {
      top_s[qq * slots + i] = -INFINITY;
      top_p[qq * slots + i] = kNoPos;
    }
  }
  __syncthreads();

  const int nc = (d + kDK - 1) / kDK;
  const int64_t n_tiles = r_end > r_begin ? (r_end - r_begin + NT - 1) / NT : 0;
  const int64_t total = n_tiles * nc;

  // The copy position runs kStages - 1 chunks ahead of the compute one;
  // both advance without a division.
  int64_t ld_it = 0, ld_t0 = r_begin;
  int ld_c = 0, ld_stage = 0;
  auto load_next = [&]() {
    if (ld_it < total)
      stage_chunk<L, VEC4>(ring + ld_stage * (NT + QT) * kLD, xb, xq, ld_t0, r_end, q0, nq, d,
                           ld_c * kDK, tid);
    cpa::commit();
    ++ld_it;
    if (++ld_c == nc) { ld_c = 0; ld_t0 += NT; }
    if (++ld_stage == kStages) ld_stage = 0;
  };
  for (int s = 0; s < kStages - 1; ++s) load_next();

  float acc[L::MT][L::NQ][4];
  float bn_part = 0.f, bn_hi = 0.f;  // this thread's share of a row; the block's max
  constexpr int TPR = kThreads / NT;   // threads summing a row's |x|^2
  const int bn_row = tid % NT, bn_sub = tid / NT;

  int64_t t0 = r_begin;
  int c = 0, stage = 0;
  for (int64_t it = 0; it < total; ++it) {
    cpa::wait_pending(kStages - 2);
    __syncthreads();
    load_next();

    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NQ; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      if (tid < NT) {
        const int64_t row = t0 + tid;
        valid_s[tid] = row < r_end && (mask == nullptr || mask[row] != 0);
      }
    }
    const float* xs = ring + stage * (NT + QT) * kLD;
    mma_chunk<L>(acc, xs, xs + NT * kLD, wm, wn, lane);
    bn_part = row_norm_part(xs, bn_row, bn_sub, kDK / TPR, bn_part);
    if (++stage == kStages) stage = 0;
    if (++c < nc) continue;
    c = 0;

    // Tile epilogue: scores in registers, threshold test, append.  A score
    // that finds its query's buffer full stays pending; the full lists are
    // sorted (raising their thresholds) and the pending scores tried again.
    bnh_s[bn_sub * NT + bn_row] = bn_part;
    bn_part = 0.f;
    __syncthreads();
    float bn_r[L::MT][2];
    uint64_t pending = 0;  // bit (mt·NQ + nt)·4 + i: fragment entry still to append
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * L::MW + mt * 16 + g + 8 * h;
        float bn = 0.f;
#pragma unroll
        for (int s = 0; s < TPR; ++s) bn += bnh_s[s * NT + rl];
        bn_r[mt][h] = bn;
        if (!valid_s[rl]) continue;
#pragma unroll
        for (int nt = 0; nt < L::NQ; ++nt)
#pragma unroll
          for (int hq = 0; hq < 2; ++hq)
            if (q0 + wn * L::QW + nt * 8 + 2 * t4 + hq < nq)
              pending |= 1ull << ((mt * L::NQ + nt) * 4 + 2 * h + hq);
      }
    if (tid < NT && valid_s[tid]) {
      float bn = 0.f;
#pragma unroll
      for (int s = 0; s < TPR; ++s) bn += bnh_s[s * NT + tid];
      bn_hi = fmaxf(bn_hi, bn);
    }
    while (true) {
      if (pending) {
        float qn_q[L::NQ][2], ts_q[L::NQ][2];
        int tp_q[L::NQ][2];
#pragma unroll
        for (int nt = 0; nt < L::NQ; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ql = wn * L::QW + nt * 8 + 2 * t4 + h;
            qn_q[nt][h] = qn_s[ql];
            ts_q[nt][h] = ts_s[ql];
            tp_q[nt][h] = tp_s[ql];
          }
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < L::NQ; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint64_t bit = 1ull << ((mt * L::NQ + nt) * 4 + i);
              if (!(pending & bit)) continue;
              const int hr = i >> 1, hq = i & 1;
              const float dot = acc[mt][nt][i];
              const float sc = l2 ? -fmaxf(qn_q[nt][hq] - 2.f * dot + bn_r[mt][hr], 0.f) : dot;
              const int row = static_cast<int>(t0 + wm * L::MW + mt * 16 + g + 8 * hr);
              if (better(sc, row, ts_q[nt][hq], tp_q[nt][hq])) {
                const int ql = wn * L::QW + nt * 8 + 2 * t4 + hq;
                const int at = atomicAdd(cnt_s + ql, 1);
                if (at >= buf) continue;  // full: stays pending
                top_s[ql * slots + k2 + at] = sc;
                top_p[ql * slots + k2 + at] = row;
              }
              pending &= ~bit;
            }
      }
      if (!__syncthreads_or(pending != 0)) break;
      for (int qq = warp; qq < QT; qq += kWarps) {
        if (cnt_s[qq] < buf) continue;  // warp-uniform
        float* s = top_s + qq * slots;
        int* p = top_p + qq * slots;
        sort_used(s, p, k2 + buf, lane);
        if (lane == 0) {
          ts_s[qq] = s[k2 - 1];
          tp_s[qq] = p[k2 - 1];
          cnt_s[qq] = 0;
        }
      }
      __syncthreads();
    }
    t0 += NT;
  }
  cpa::wait_pending(0);

  // The block's largest |x|^2 over valid rows (non-negative: int order).
  if (warp < NT / 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) bn_hi = fmaxf(bn_hi, __shfl_xor_sync(kFull, bn_hi, off));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(bn_max), __float_as_int(bn_hi));
  }
  for (int qq = warp; qq < QT; qq += kWarps) {
    const int q = q0 + qq;
    if (q >= nq) continue;
    float* s = top_s + qq * slots;
    int* p = top_p + qq * slots;
    const int cnt = min(cnt_s[qq], buf);
    if (cnt > 0) sort_used(s, p, k2 + cnt, lane);
    const int64_t base = (static_cast<int64_t>(q) * splits + split_id) * k2;
    for (int t = lane; t < k2; t += 32) {
      part_s[base + t] = s[t];
      part_p[base + t] = p[t];
    }
  }
}

// The bound E of the source note for one query.
__device__ __forceinline__ float error_bound(float qn, float bn_hi, int d, int l2) {
  const float u = 5.9604645e-8f;  // 2^-24
  const float eps = 3.01f * 16.f * u + 3.f * ((d + 7) / 8) * 4.f * u + d * u;
  const float s = sqrtf(qn) * sqrtf(bn_hi) * 1.001f;
  return l2 ? 2.f * s * eps + (2.f * d + 4.f) * u * (qn + bn_hi) + 8.f * u * s : s * eps;
}

// The merge's last steps, shared with the dense regime's select: sort the
// K2 rescored candidates (s, p: a power of two >= k2 slots) by exact score
// then position, write the best k, and count the query unproven when its
// K2-th 3xTF32 score a_last comes within 2E of the k-th exact score.  One
// warp.
__device__ __forceinline__ void finish_query(float* s, int* p, int k, int k2, bool full,
                                             float a_last, float qn, float bn_hi, int d, int l2,
                                             float* __restrict__ out_s, int* __restrict__ out_p,
                                             int* __restrict__ unproven, int64_t q, int lane) {
  sort_used(s, p, k2, lane);
  for (int t = lane; t < k; t += 32) {
    const float sc = s[t];
    const int pos = p[t];
    const bool missing = pos == kNoPos || sc == -INFINITY;
    out_s[q * k + t] = missing ? -INFINITY : sc;
    out_p[q * k + t] = missing ? -1 : pos;
  }
  const float e_k = s[k - 1];
  if (lane == 0 && full && e_k > -INFINITY && a_last >= e_k - 2.f * error_bound(qn, bn_hi, d, l2))
    atomicAdd(unproven, 1);
}

__global__ void __launch_bounds__(kThreads)
flat_topk_merge(const float* __restrict__ xb, const float* __restrict__ xq,
                const float* __restrict__ part_s, const int* __restrict__ part_p,
                const float* __restrict__ bn_max, int nq, int d, int splits, int k,
                int k2, int slots, int l2, float* __restrict__ out_s,
                int* __restrict__ out_p, int* __restrict__ unproven) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * warps + warp;
  if (q >= nq) return;  // warp-uniform; this kernel has no block barrier
  float* s = reinterpret_cast<float*>(smem) + warp * slots;
  int* p = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + warps * slots)
           + warp * slots;
  TopK top;
  top.init(s, p, k2, slots, lane);

  const float* qs = part_s + static_cast<int64_t>(q) * splits * k2;
  const int* qp = part_p + static_cast<int64_t>(q) * splits * k2;
  push_sorted_lists(top, qs, qp, splits, lane, k2);
  if (top.cnt > 0) top.flush(lane);
  const float a_last = s[k2 - 1];
  const bool full = p[k2 - 1] != kNoPos;

  // Exact fp32 rescore of the K2 candidates.
  const float* qrow = xq + static_cast<int64_t>(q) * d;
  const float qn = query_norm(qrow, d, lane);
  // A lane a candidate, each sum taken in dimension order (as a cuBLAS
  // SGEMM thread accumulates along k): the plain version's rounding.
  __syncwarp();
  for (int i = lane; i < k2; i += 32) {
    const int pos = p[i];
    if (pos == kNoPos) continue;
    const float* xrow = xb + static_cast<int64_t>(pos) * d;
    float dot = 0.f, bn = 0.f;
    for (int c = 0; c < d; ++c) {
      const float x = xrow[c];
      dot = fmaf(qrow[c], x, dot);
      bn = fmaf(x, x, bn);
    }
    s[i] = l2 ? -fmaxf(qn - 2.f * dot + bn, 0.f) : dot;
  }
  __syncwarp();
  finish_query(s, p, k, k2, full, a_last, qn, *bn_max, d, l2, out_s, out_p, unproven, q, lane);
}

// ---- The dense regime: (c) flat_topk_dense, (d) flat_topk_select ----

template <class L, int STAGES>
__host__ __device__ constexpr size_t dense_smem() {
  return sizeof(float) * (STAGES * (L::NT + L::QT) * kLD + kThreads + L::QT);
}

// Every 3xTF32 score of a query tile x row tile, written to the (nq, n_scan)
// score tile, and the tile's largest valid |x|^2 (from the first query
// tile's block) to bn_tile.  The partial's staging, products, norms and
// epilogue arithmetic; bn_parts threads sum a row's |x|^2, as in the
// partial the split plan would launch for this nq.  STAGES chunks in the
// ring: a small tile needs more in flight to cover the copies' latency.
template <class L, int STAGES, bool VEC4>
__global__ void __launch_bounds__(kThreads)
flat_topk_dense(const float* __restrict__ xb, const float* __restrict__ xq,
                const int8_t* __restrict__ mask, int nq, int d, int n_scan, int bn_parts,
                int l2, float* __restrict__ scores, float* __restrict__ bn_tile) {
  constexpr int NT = L::NT, QT = L::QT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);        // [stage][NT + QT][kLD]
  float* bnh_s = ring + STAGES * (NT + QT) * kLD;       // [bn_parts][NT]
  float* qn_s = bnh_s + kThreads;                     // [QT]
  __shared__ int bn_hi_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % L::WM, wn = warp / L::WM;
  const int q0 = blockIdx.x * QT;
  const int t0 = blockIdx.y * NT;
  const int r_end = min(t0 + NT, n_scan);

  if (tid == 0) bn_hi_s = 0;
  for (int qq = warp; qq < QT; qq += kWarps) {
    const float qn =
        l2 && q0 + qq < nq ? query_norm(xq + static_cast<int64_t>(q0 + qq) * d, d, lane) : 0.f;
    if (lane == 0) qn_s[qq] = qn;
  }

  const int nc = (d + kDK - 1) / kDK;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc)
      stage_chunk<L, VEC4>(ring + s * (NT + QT) * kLD, xb, xq, t0, r_end, q0, nq, d, s * kDK,
                           tid);
    cpa::commit();
  }
  float acc[L::MT][L::NQ][4];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NQ; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float bn_part = 0.f;
  const int bn_row = tid % NT, bn_sub = tid / NT, dpt = kDK / bn_parts;
  for (int c = 0; c < nc; ++c) {
    cpa::wait_pending(STAGES - 2);
    __syncthreads();
    const int ahead = c + STAGES - 1;
    if (ahead < nc)
      stage_chunk<L, VEC4>(ring + (ahead % STAGES) * (NT + QT) * kLD, xb, xq, t0, r_end, q0,
                           nq, d, ahead * kDK, tid);
    cpa::commit();
    const float* xs = ring + (c % STAGES) * (NT + QT) * kLD;
    mma_chunk<L>(acc, xs, xs + NT * kLD, wm, wn, lane);
    if (bn_sub < bn_parts) bn_part = row_norm_part(xs, bn_row, bn_sub, dpt, bn_part);
  }
  cpa::wait_pending(0);
  if (bn_sub < bn_parts) bnh_s[bn_sub * NT + bn_row] = bn_part;
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * L::MW + mt * 16 + g + 8 * h;
      float bn = 0.f;
      for (int s = 0; s < bn_parts; ++s) bn += bnh_s[s * NT + rl];
      if (t0 + rl >= n_scan) continue;
#pragma unroll
      for (int nt = 0; nt < L::NQ; ++nt)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const int ql = wn * L::QW + nt * 8 + 2 * t4 + hq;
          if (q0 + ql >= nq) continue;
          const float dot = acc[mt][nt][2 * h + hq];
          scores[static_cast<int64_t>(q0 + ql) * n_scan + t0 + rl] =
              l2 ? -fmaxf(qn_s[ql] - 2.f * dot + bn, 0.f) : dot;
        }
    }
  if (blockIdx.x != 0) return;  // block-uniform
  if (tid < NT && t0 + tid < r_end && (mask == nullptr || mask[t0 + tid] != 0)) {
    float bn = 0.f;
    for (int s = 0; s < bn_parts; ++s) bn += bnh_s[s * NT + tid];
    atomicMax(&bn_hi_s, __float_as_int(bn));  // non-negative: int order
  }
  __syncthreads();
  if (tid == 0) bn_tile[blockIdx.y] = __int_as_float(bn_hi_s);
}

constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;

// Shared-memory bytes of flat_topk_select: the histogram, the candidates'
// ks slots, and `buffer` floats that hold the query's order keys, then the
// rescore's staged rows (ops/flat_topk.py::dense_plan sizes it).
__host__ __device__ constexpr size_t select_smem(int ks, int buffer) {
  return sizeof(int) * 256 + 8 * static_cast<size_t>(ks) + sizeof(float) * buffer;
}

// An unsigned key in the order of better()'s scores: larger is better; -0
// keys as +0, which better() ties with it.  No score keys as 0 (the key of
// a negative NaN's bits), which marks a row that cannot be a candidate.
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t b = __float_as_uint(s == 0.f ? 0.f : s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? key ^ 0x80000000u : ~key);
}

// One block a query: the best K2 of its valid scores by (3xTF32 score
// descending, position ascending), which is the set the split's partial
// and merge keep; their exact fp32 rescore, each sum in dimension order
// over rows staged through shared memory; then the merge's sort, output and
// unproven count.
__global__ void __launch_bounds__(kSelThreads)
flat_topk_select(const float* __restrict__ xb, const float* __restrict__ xq,
                 const int8_t* __restrict__ mask, const float* __restrict__ scores,
                 const float* __restrict__ bn_tile, int n_tiles, int d, int n_scan, int k,
                 int k2, int ks, int buffer, int l2, float* __restrict__ out_s,
                 int* __restrict__ out_p, int* __restrict__ unproven) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);                  // [256]
  float* cs = reinterpret_cast<float*>(hist + 256);          // [ks]
  int* cp = reinterpret_cast<int*>(cs + ks);                 // [ks]
  uint32_t* keys = reinterpret_cast<uint32_t*>(cp + ks);     // [buffer]: keys, then
  float* stage = reinterpret_cast<float*>(keys);             // the staged rows
  __shared__ uint32_t prefix_s;
  __shared__ int need_s, total_s, exact_s, cnt_s;
  __shared__ float qn_s, bn_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t q = blockIdx.x;
  const float* srow = scores + q * n_scan;
  const float* qrow = xq + q * d;

  if (warp == 0) {
    const float qn = query_norm(qrow, d, lane);
    if (lane == 0) {
      qn_s = qn;
      cnt_s = 0;
    }
  } else if (warp == 1) {
    float m = 0.f;
    for (int i = lane; i < n_tiles; i += 32) m = fmaxf(m, bn_tile[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) bn_s = m;
  }
#pragma unroll 4
  for (int i = tid; i < n_scan; i += kSelThreads) {
    const float s = srow[i];  // NaN never passes better()
    keys[i] = s == s && (mask == nullptr || mask[i] != 0) ? order_key(s) : 0u;
  }

  // Radix select, 8 bits a pass from the top: the K2-th best key lies in
  // the bucket `prefix` of the bits under `pmask`, `need` of it to take.
  // A pass stops early where the whole bucket is needed (exact).
  uint32_t prefix = 0, pmask = 0;
  int need = 0, total = 0;
  bool exact = false;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n_scan; i0 += kSelThreads) {
      const int i = i0 + tid;
      int bin = 256;
      if (i < n_scan) {
        const uint32_t key = keys[i];
        if (key != 0 && (key & pmask) == prefix) bin = (key >> shift) & 255;
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin < 256 && lane == __ffs(peers) - 1) atomicAdd(hist + bin, __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds buckets 255 - 8l down to 248 - 8l.
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += c[j] = hist[255 - 8 * lane - j];
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      const int tot = __shfl_sync(kFull, incl, 31);
      const int want = shift == 24 ? min(k2, tot) : need;
      const unsigned hit = __ballot_sync(kFull, want > 0 && incl >= want && incl - sum < want);
      const int src = hit ? __ffs(hit) - 1 : 0;
      int digit = 0, above = incl - sum, cnt = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cnt == 0 && above + c[j] >= want) {
          digit = 255 - 8 * lane - j;
          cnt = c[j];
        } else if (cnt == 0) {
          above += c[j];
        }
      }
      digit = __shfl_sync(kFull, digit, src);
      above = __shfl_sync(kFull, above, src);
      cnt = __shfl_sync(kFull, cnt, src);
      if (lane == 0) {
        if (shift == 24) total_s = tot;
        prefix_s = prefix | static_cast<uint32_t>(digit) << shift;
        need_s = hit ? want - above : 0;
        exact_s = !hit || cnt == want - above;
      }
    }
    __syncthreads();
    prefix = prefix_s;
    pmask |= 0xffu << shift;
    need = need_s;
    exact = exact_s;
    total = total_s;
    if (exact) break;  // block-uniform
  }

  // Collect every key above the bucket, and the bucket's keys: all when
  // exact, else (exact ties at the K2-th key) the `need` first by position.
  const int cnt = min(k2, total);
  for (int i = tid; i < n_scan; i += kSelThreads) {
    const uint32_t key = keys[i];
    const uint32_t m = key & pmask;
    if (key != 0 && (m > prefix || (exact && m == prefix))) {
      const int at = atomicAdd(&cnt_s, 1);
      cs[at] = key_score(key);
      cp[at] = i;
    }
  }
  for (int i = cnt + tid; i < ks; i += kSelThreads) {
    cs[i] = -INFINITY;
    cp[i] = kNoPos;
  }
  __syncthreads();
  if (!exact && warp == 0) {
    const int base = cnt_s;
    int taken = 0;
    for (int i0 = 0; i0 < n_scan && taken < need; i0 += 32) {
      const int i = i0 + lane;
      const bool eq = i < n_scan && keys[i] != 0 && keys[i] == prefix;
      const unsigned b = __ballot_sync(kFull, eq);
      const int rank = taken + __popc(b & ((1u << lane) - 1u));
      if (eq && rank < need) {
        cs[base + rank] = key_score(prefix);
        cp[base + rank] = i;
      }
      taken += __popc(b);
    }
  }
  float a_last = INFINITY;  // the K2-th 3xTF32 score (warp 0)
  if (warp == 0) {
    __syncwarp();
    for (int i = lane; i < cnt; i += 32) a_last = fminf(a_last, cs[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a_last = fminf(a_last, __shfl_xor_sync(kFull, a_last, off));
  }

  // Exact fp32 rescore: a thread a candidate; the rows staged with cp.async
  // in chunks of ch dims (row stride ch + 1: conflict-free reads), as few
  // and as even as the buffer allows.
  const float qn = qn_s;
  for (int g0 = 0; g0 < cnt; g0 += kSelThreads) {
    const int rows = min(kSelThreads, cnt - g0);
    const int room = (buffer - rows) / (rows + 1);
    const int ch = (d + (d + room - 1) / room - 1) / ((d + room - 1) / room);
    float* qs = stage + rows * (ch + 1);
    float dot = 0.f, bn = 0.f;
    for (int c0 = 0; c0 < d; c0 += ch) {
      const int w = min(ch, d - c0);
      __syncthreads();  // the buffer's readers are done: the keys, the last chunk
      for (int r = warp; r < rows; r += kSelWarps) {
        const float* src = xb + static_cast<int64_t>(cp[g0 + r]) * d + c0;
        float* dst = stage + r * (ch + 1);
        for (int c = lane; c < w; c += 32) cpa::copy4(dst + c, src + c);
      }
      for (int c = tid; c < w; c += kSelThreads) cpa::copy4(qs + c, qrow + c0 + c);
      cpa::commit();
      cpa::wait_pending(0);
      __syncthreads();
      if (tid < rows) {
        const float* xr = stage + tid * (ch + 1);
        int c = 0;
        for (; c + 8 <= w; c += 8) {  // eight loads in flight, the sums in order
          float x[8], y[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            x[j] = xr[c + j];
            y[j] = qs[c + j];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dot = fmaf(y[j], x[j], dot);
            bn = fmaf(x[j], x[j], bn);
          }
        }
        for (; c < w; ++c) {
          const float x = xr[c];
          dot = fmaf(qs[c], x, dot);
          bn = fmaf(x, x, bn);
        }
      }
    }
    if (tid < rows) cs[g0 + tid] = l2 ? -fmaxf(qn - 2.f * dot + bn, 0.f) : dot;
  }
  __syncthreads();
  if (warp == 0)
    finish_query(cs, cp, k, k2, total >= k2, a_last, qn, bn_s, d, l2, out_s, out_p, unproven, q,
                 lane);
}

template <int QT, bool VEC4>
cudaError_t launch_partial(const float* xb, const float* xq, const int8_t* mask, int nq, int d,
                           int64_t n_scan, int64_t rows_per_split, int splits, int k2,
                           int slots, int l2, float* part_s, int* part_p, float* bn_max,
                           cudaStream_t stream) {
  const size_t smem = partial_smem(QT, slots);
  cudaError_t err = cudaFuncSetAttribute(flat_topk_partial<QT, VEC4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + QT - 1) / QT, splits);
  flat_topk_partial<QT, VEC4><<<grid, kThreads, smem, stream>>>(
      xb, xq, mask, nq, d, n_scan, rows_per_split, k2, slots, l2, part_s, part_p, bn_max);
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_partial_vec(bool vec4, const float* xb, const float* xq, const int8_t* mask,
                               int nq, int d, int64_t n_scan, int64_t rows_per_split,
                               int splits, int k2, int slots, int l2, float* part_s,
                               int* part_p, float* bn_max, cudaStream_t stream) {
  return vec4 ? launch_partial<QT, true>(xb, xq, mask, nq, d, n_scan, rows_per_split, splits,
                                         k2, slots, l2, part_s, part_p, bn_max, stream)
              : launch_partial<QT, false>(xb, xq, mask, nq, d, n_scan, rows_per_split, splits,
                                          k2, slots, l2, part_s, part_p, bn_max, stream);
}

// The score launch of tile L with a ring of STAGES; n_tiles receives its
// row tiles.
template <class L, int STAGES>
cudaError_t launch_dense(bool vec4, const float* xb, const float* xq, const int8_t* mask,
                         int nq, int d, int n_scan, int bn_parts, int l2, float* scores,
                         float* bn_tile, int* n_tiles, cudaStream_t stream) {
  auto kernel = vec4 ? flat_topk_dense<L, STAGES, true> : flat_topk_dense<L, STAGES, false>;
  const size_t smem = dense_smem<L, STAGES>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *n_tiles = (n_scan + L::NT - 1) / L::NT;
  const dim3 grid((nq + L::QT - 1) / L::QT, *n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(xb, xq, mask, nq, d, n_scan, bn_parts, l2, scores,
                                             bn_tile);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launches (0 on success).  The caller sizes
// part_s/part_p as (nq, splits, k2) and out_s/out_p as (nq, k), passes
// bn_max as one zeroed float and unproven as an int it reads or zeroes
// itself; qt is 8, 16, 32 or 64, slots a power of two >= k2 + 128 with
// partial_smem(qt, slots) within the card's shared memory, rows_per_split
// a multiple of 128 with splits * rows_per_split >= n_scan, merge_slots a
// power of two >= 2 * k2, and vec4 = 1 only with d a multiple of 4 and
// 16-byte aligned xb and xq.
extern "C" int dfx_flat_topk(const float* xb, const float* xq, const int8_t* mask, int nq, int d,
                             long long n_scan, int k, int k2, int l2, int qt, int vec4,
                             int splits, long long rows_per_split, int slots, int merge_slots,
                             int merge_warps, float* part_s, int* part_p, float* bn_max,
                             float* out_s, int* out_p, int* unproven, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
#define DFX_PARTIAL(QT)                                                                      \
  launch_partial_vec<QT>(vec4, xb, xq, mask, nq, d, n_scan, rows_per_split, splits, k2, slots, \
                         l2, part_s, part_p, bn_max, stream)
  switch (qt) {
    case 8: err = DFX_PARTIAL(8); break;
    case 16: err = DFX_PARTIAL(16); break;
    case 32: err = DFX_PARTIAL(32); break;
    case 64: err = DFX_PARTIAL(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DFX_PARTIAL
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t msmem = (sizeof(float) + sizeof(int)) * static_cast<size_t>(merge_warps) *
                       merge_slots;
  err = cudaFuncSetAttribute(flat_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(msmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mblocks = (nq + merge_warps - 1) / merge_warps;
  flat_topk_merge<<<mblocks, 32 * merge_warps, msmem, stream>>>(
      xb, xq, part_s, part_p, bn_max, nq, d, splits, k, k2, merge_slots, l2, out_s, out_p,
      unproven);
  return static_cast<int>(cudaGetLastError());
}

// The dense regime.  Returns the CUDA error of the launches (0 on
// success).  The caller sizes scores as (nq, n_scan) and bn_tile as the
// score launch's row tiles (n_scan over the tile's rows, rounded up),
// out_s/out_p as (nq, k), passes unproven as for dfx_flat_topk; tile 0 or
// 1 (DenseWide, DenseSquare), 1 <= n_scan <= 32768 (the
// select's keys in shared memory), bn_parts 1 or 2
// (the split plan's threads a row's |x|^2), ks the power of two >= k2,
// buffer the select's floats beside them (at least n_scan, and room for a
// candidate row's chunk), and vec4 as for dfx_flat_topk.
extern "C" int dfx_flat_topk_dense(const float* xb, const float* xq, const int8_t* mask, int nq,
                                   int d, int n_scan, int k, int k2, int l2, int tile, int vec4,
                                   int bn_parts, int ks, int buffer, float* scores, float* bn_tile,
                                   float* out_s, int* out_p, int* unproven, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  int n_tiles = 0;
#define DFX_DENSE(L, STAGES)                                                                \
  launch_dense<L, STAGES>(vec4, xb, xq, mask, nq, d, n_scan, bn_parts, l2, scores, bn_tile,   \
                          &n_tiles, stream)
  switch (tile) {
    case 0: err = DFX_DENSE(DenseWide, kStages); break;
    case 1: err = DFX_DENSE(DenseSquare, 5); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DFX_DENSE
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t ssmem = select_smem(ks, buffer);
  err = cudaFuncSetAttribute(flat_topk_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ssmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flat_topk_select<<<nq, kSelThreads, ssmem, stream>>>(xb, xq, mask, scores, bn_tile, n_tiles, d,
                                                       n_scan, k, k2, ks, buffer, l2, out_s,
                                                       out_p, unproven);
  return static_cast<int>(cudaGetLastError());
}
