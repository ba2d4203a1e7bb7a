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

// Tile shape of a query tile of QT: NT corpus rows a tile (256 beside 32 or
// 64 queries, 128 beside fewer); WN warps along the queries, WM along the
// rows; each warp holds MT x NQ fragments of 16 rows x 8 queries.
template <int QT>
struct Layout {
  static constexpr int NT = QT >= 32 ? 256 : 128;
  static constexpr int WN = QT >= 16 ? 2 : 1;
  static constexpr int WM = kWarps / WN;
  static constexpr int MW = NT / WM;      // rows a warp
  static constexpr int QW = QT / WN;      // queries a warp
  static constexpr int MT = MW / 16;
  static constexpr int NQ = QW / 8;
  static constexpr int TPR = kThreads / NT;  // threads summing a row's |x|^2
};

__host__ __device__ constexpr int tile_rows(int qt) { return qt >= 32 ? 256 : 128; }

// Shared-memory bytes of flat_topk_partial<QT> with `slots` a query.
__host__ __device__ constexpr size_t partial_smem(int qt, int slots) {
  return sizeof(float) * kStages * (tile_rows(qt) + qt) * kLD  // the ring
         + sizeof(float) * kThreads + tile_rows(qt)           // |x|^2 parts, row validity
         + 16 * static_cast<size_t>(qt)                       // qn, ts, tp, cnt
         + 8 * static_cast<size_t>(qt) * slots;               // candidate lists
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
    float acc = 0.f;
    if (l2 && q0 + qq < nq) {
      const float* qrow = xq + static_cast<int64_t>(q0 + qq) * d;
      for (int c = lane; c < d; c += 32) acc = fmaf(qrow[c], qrow[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) {
      qn_s[qq] = acc;
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

  // Into stage `stage`: rows [t0, t0 + NT) and all QT queries, dims
  // [c0, c0 + kDK).
  auto load = [&](int stage, int64_t t0, int c0) {
    float* st = ring + stage * (NT + QT) * kLD;
    if (VEC4) {
      // A thread copies 16 bytes (dims c4 .. c4 + 3) of rows r0, r0 + 32,
      // ...: corpus rows, then query rows past NT.
      const int r0 = tid >> 3, c4 = (tid & 7) * 4;
      const bool dims = c0 + c4 < d;
      const float* rows = xb + (t0 + r0) * d + c0 + c4;
#pragma unroll
      for (int j = 0; j < (NT + QT + 31) / 32; ++j) {
        const int rr = r0 + 32 * j;
        const float* src = xb;
        int bytes = 0;
        if (32 * j < NT) {
          if (t0 + rr < r_end && dims) { src = rows + static_cast<int64_t>(32 * j) * d; bytes = 16; }
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
  };

  // The copy position runs kStages - 1 chunks ahead of the compute one;
  // both advance without a division.
  int64_t ld_it = 0, ld_t0 = r_begin;
  int ld_c = 0, ld_stage = 0;
  auto load_next = [&]() {
    if (ld_it < total) load(ld_stage, ld_t0, ld_c * kDK);
    cpa::commit();
    ++ld_it;
    if (++ld_c == nc) { ld_c = 0; ld_t0 += NT; }
    if (++ld_stage == kStages) ld_stage = 0;
  };
  for (int s = 0; s < kStages - 1; ++s) load_next();

  float acc[L::MT][L::NQ][4];
  float bn_part = 0.f, bn_hi = 0.f;  // this thread's share of a row; the block's max
  const int bn_row = tid % NT, bn_sub = tid / NT;
  constexpr int kDPT = kDK / L::TPR;   // dims a thread sums, a chunk

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
    const float* qsm = xs + NT * kLD;
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
    {  // |x|^2: this thread's kDPT dims of its row, a chunk
      const float4* xr = reinterpret_cast<const float4*>(xs + bn_row * kLD + kDPT * bn_sub);
#pragma unroll
      for (int j = 0; j < kDPT / 4; ++j) {
        const float4 v = xr[j];
        bn_part = fmaf(v.x, v.x, bn_part);
        bn_part = fmaf(v.y, v.y, bn_part);
        bn_part = fmaf(v.z, v.z, bn_part);
        bn_part = fmaf(v.w, v.w, bn_part);
      }
    }
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
        for (int s = 0; s < L::TPR; ++s) bn += bnh_s[s * NT + rl];
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
      for (int s = 0; s < L::TPR; ++s) bn += bnh_s[s * NT + tid];
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
  float qn = 0.f;
  for (int c = lane; c < d; c += 32) qn = fmaf(qrow[c], qrow[c], qn);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(kFull, qn, off);
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
  sort_used(s, p, k2, lane);
  for (int t = lane; t < k; t += 32) {
    const float sc = s[t];
    const int pos = p[t];
    const bool missing = pos == kNoPos || sc == -INFINITY;
    out_s[static_cast<int64_t>(q) * k + t] = missing ? -INFINITY : sc;
    out_p[static_cast<int64_t>(q) * k + t] = missing ? -1 : pos;
  }
  const float e_k = s[k - 1];
  if (lane == 0 && full && e_k > -INFINITY &&
      a_last >= e_k - 2.f * error_bound(qn, *bn_max, d, l2))
    atomicAdd(unproven, 1);
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
