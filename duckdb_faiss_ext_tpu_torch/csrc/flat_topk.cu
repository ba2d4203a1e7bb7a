// Fused L2 / inner-product distance + exact top-k over a flat corpus, for
// Hopper (sm_90a).  Replaces the TPU kernel
// duckdb_faiss_ext_tpu/ops/pallas_topk.py::_topk_kernel; the Python wrapper
// is duckdb_faiss_ext_tpu_torch/ops/flat_topk.py.
//
// Contract: for each query q, the k corpus rows r < n_scan (and with
// mask[r] != 0 when a mask is given) with the best max-oriented score,
//   IP: q·x        L2: -max(|q|^2 - 2 q·x + |x|^2, 0)
// sorted score descending, then position ascending.  Missing slots are
// (-inf, -1).  Dot products and norms are fp32 FMA in this kernel.
//
// Design.  The TPU kernel carried its top-k in VMEM across a sequential
// grid axis; GPU blocks run in parallel and in no order, so the work is two
// launches:
//   (a) flat_topk_partial: grid = query tiles x corpus splits.  A block
//       stages 128-row corpus tiles through shared memory in 32-dim chunks
//       and each warp scores its RQ queries against the tile.  Each query's
//       running top-k lives in shared memory and is owned by one warp:
//       slots [0,k) hold the current best k sorted, slots [k, slots) collect
//       candidates that beat the k-th best (ballot + popc, no atomics); a
//       warp-wide bitonic sort folds them back in when the buffer fills.
//       Once the k-th best settles, almost no score passes the threshold,
//       so the selection costs one compare per score.  Each block writes
//       its split's sorted top-k to (nq, splits, k) partials.
//       As in the TPU kernel, a tile whose scores all fail a query's
//       threshold is skipped with one warp vote.
//   (b) flat_topk_merge: one warp per query streams the splits' sorted
//       lists through the same buffer (32 / k lists a step when k < 32)
//       and stops reading a list at the first 32 entries that all fail
//       the threshold.
// What bounds it on the H100: at small batches (b48) reading the corpus
// (1M x 128 x 4 B = 512 MB at 3.35 TB/s, about 0.15 ms); the query-tile
// index is the fastest grid axis so blocks of one split run together and
// share its rows through L2.  At large batches (b1024) fp32 FMA throughput;
// each thread keeps an RQ x 4 register tile of dot products.  Tensor cores
// (TF32/bf16), TMA and wgmma are left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 128;         // corpus rows per tile (4 per lane)
constexpr int kDK = 32;          // dims per staged chunk
constexpr int kPad = kNT + 1;    // transposed tile row stride: no bank conflicts
constexpr int kNoPos = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int p, float ts, int tp) {
  return s > ts || (s == ts && p < tp);
}

// Bitonic sort of n (a power of two) slots best-first, by one warp.
__device__ void warp_sort(float* s, int* p, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < (n >> 1); i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const float sl = s[lo], sh = s[hi];
        const int pl = p[lo], ph = p[hi];
        const bool swap = (lo & size) == 0 ? better(sh, ph, sl, pl)
                                           : better(sl, pl, sh, ph);
        if (swap) {
          s[lo] = sh; s[hi] = sl;
          p[lo] = ph; p[hi] = pl;
        }
      }
      __syncwarp();
    }
  }
}

// One query's running top-k, owned by one warp.  Slots [0, k) are the best
// k so far, sorted; [k, k + cnt) unsorted candidates; (ts, tp) is slot k-1.
struct TopK {
  float* s;
  int* p;
  int k;
  int buf;      // candidate capacity: slots - k
  int cnt;
  float ts;
  int tp;

  __device__ void init(float* s_, int* p_, int k_, int slots, int lane) {
    s = s_; p = p_; k = k_; buf = slots - k_; cnt = 0;
    ts = -INFINITY; tp = kNoPos;
    for (int i = lane; i < k; i += 32) { s[i] = -INFINITY; p[i] = kNoPos; }
    __syncwarp();
  }

  __device__ void flush(int lane) {
    const int used = k + cnt;
    int n = 1;
    while (n < used) n <<= 1;
    for (int i = used + lane; i < n; i += 32) { s[i] = -INFINITY; p[i] = kNoPos; }
    __syncwarp();
    warp_sort(s, p, n, lane);
    ts = s[k - 1];
    tp = p[k - 1];
    cnt = 0;
    __syncwarp();
  }

  // One candidate per lane; all 32 lanes call together.
  __device__ __forceinline__ bool passes(bool valid, float sc, int pos) const {
    return valid && better(sc, pos, ts, tp);
  }

  __device__ void push(bool valid, float sc, int pos, int lane) {
    bool pass = passes(valid, sc, pos);
    unsigned b = __ballot_sync(kFull, pass);
    if (b == 0) return;
    if (cnt + __popc(b) > buf) {
      flush(lane);
      pass = passes(valid, sc, pos);
      b = __ballot_sync(kFull, pass);
    }
    if (pass) {
      const int at = k + cnt + __popc(b & ((1u << lane) - 1u));
      s[at] = sc;
      p[at] = pos;
    }
    cnt += __popc(b);
  }
};

template <int RQ, bool VEC4>
__global__ void __launch_bounds__(kThreads)
flat_topk_partial(const float* __restrict__ xb, const float* __restrict__ xq,
                  const int8_t* __restrict__ mask, int nq, int d,
                  int64_t n_scan, int64_t rows_per_split, int k, int slots,
                  int l2, float* __restrict__ part_s, int* __restrict__ part_p) {
  constexpr int QT = kWarps * RQ;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xq_s = reinterpret_cast<float*>(smem);      // QT x kDK
  float* xb_s = xq_s + QT * kDK;                     // kDK x kPad
  float* bn_s = xb_s + kDK * kPad;                   // kNT
  float* top_s = bn_s + kNT;                         // QT x slots
  int* top_p = reinterpret_cast<int*>(top_s + QT * slots);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y, splits = gridDim.y;
  const int64_t r_begin = static_cast<int64_t>(split) * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n_scan ? r_begin + rows_per_split : n_scan;

  TopK top[RQ];
  float qn[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qq = warp * RQ + i;
    top[i].init(top_s + qq * slots, top_p + qq * slots, k, slots, lane);
    float acc = 0.f;
    if (q0 + qq < nq) {
      const float* qrow = xq + static_cast<int64_t>(q0 + qq) * d;
      for (int c = lane; c < d; c += 32) acc = fmaf(qrow[c], qrow[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    qn[i] = acc;
  }

  for (int64_t t0 = r_begin; t0 < r_end; t0 += kNT) {
    float acc[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float bn = 0.f;

    for (int c0 = 0; c0 < d; c0 += kDK) {
      __syncthreads();  // readers of the previous chunk are done
      for (int i = tid; i < QT * kDK; i += kThreads) {
        const int qq = i / kDK, cc = i % kDK;
        xq_s[i] = q0 + qq < nq && c0 + cc < d
                      ? xq[static_cast<int64_t>(q0 + qq) * d + c0 + cc] : 0.f;
      }
      if (VEC4) {
        for (int i = tid; i < kNT * (kDK / 4); i += kThreads) {
          const int rr = i / (kDK / 4), c4 = (i % (kDK / 4)) * 4;
          const int64_t row = t0 + rr;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < r_end && c0 + c4 < d)
            v = *reinterpret_cast<const float4*>(xb + row * d + c0 + c4);
          xb_s[(c4 + 0) * kPad + rr] = v.x;
          xb_s[(c4 + 1) * kPad + rr] = v.y;
          xb_s[(c4 + 2) * kPad + rr] = v.z;
          xb_s[(c4 + 3) * kPad + rr] = v.w;
        }
      } else {
        for (int i = tid; i < kNT * kDK; i += kThreads) {
          const int rr = i / kDK, cc = i % kDK;
          const int64_t row = t0 + rr;
          xb_s[cc * kPad + rr] =
              row < r_end && c0 + cc < d ? xb[row * d + c0 + cc] : 0.f;
        }
      }
      __syncthreads();
      const int dn = min(kDK, d - c0);
      if (l2 && tid < kNT) {
        for (int dd = 0; dd < dn; ++dd) {
          const float v = xb_s[dd * kPad + tid];
          bn = fmaf(v, v, bn);
        }
      }
      const float* qbase = xq_s + warp * RQ * kDK;
#pragma unroll 4
      for (int dd = 0; dd < dn; ++dd) {
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xb_s[dd * kPad + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float a = qbase[i * kDK + dd];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
    if (l2 && tid < kNT) bn_s[tid] = bn;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      if (q0 + warp * RQ + i >= nq) continue;  // warp-uniform
      float sc[4];
      bool valid[4];
      bool any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = lane + 32 * j;
        const int64_t row = t0 + col;
        valid[j] = row < r_end && (mask == nullptr || mask[row] != 0);
        sc[j] = l2 ? -fmaxf(qn[i] - 2.f * acc[i][j] + bn_s[col], 0.f)
                   : acc[i][j];
        any |= top[i].passes(valid[j], sc[j], static_cast<int>(row));
      }
      // Tile skip (as in the TPU kernel): once the k-th best has settled,
      // most tiles hold no score that beats it, and one vote skips them.
      if (!__any_sync(kFull, any)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        top[i].push(valid[j], sc[j], static_cast<int>(t0 + lane + 32 * j),
                    lane);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q = q0 + warp * RQ + i;
    if (q >= nq) continue;
    if (top[i].cnt > 0) top[i].flush(lane);
    const int64_t base = (static_cast<int64_t>(q) * splits + split) * k;
    for (int t = lane; t < k; t += 32) {
      part_s[base + t] = top[i].s[t];
      part_p[base + t] = top[i].p[t];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flat_topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_p,
                int nq, int splits, int k, int slots,
                float* __restrict__ out_s, int* __restrict__ out_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * warps + warp;
  if (q >= nq) return;  // warp-uniform; this kernel has no block barrier
  float* s = reinterpret_cast<float*>(smem) + warp * slots;
  int* p = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + warps * slots)
           + warp * slots;
  TopK top;
  top.init(s, p, k, slots, lane);

  const float* qs = part_s + static_cast<int64_t>(q) * splits * k;
  const int* qp = part_p + static_cast<int64_t>(q) * splits * k;
  if (k < 32) {
    // Short lists: each step reads 32 / k whole lists, one entry a lane.
    const int per = 32 / k;
    for (int sp0 = 0; sp0 < splits; sp0 += per) {
      const int sp = sp0 + lane / k;
      float sc = -INFINITY;
      int pos = kNoPos;
      if (lane < per * k && sp < splits) {
        sc = qs[sp * k + lane % k];
        pos = qp[sp * k + lane % k];
      }
      top.push(pos != kNoPos, sc, pos, lane);
    }
  }
  for (int sp = 0; k >= 32 && sp < splits; ++sp) {
    for (int base = 0; base < k; base += 32) {
      const int idx = base + lane;
      float sc = -INFINITY;
      int pos = kNoPos;
      if (idx < k) {
        sc = qs[sp * k + idx];
        pos = qp[sp * k + idx];
      }
      const bool valid = pos != kNoPos;
      // Each split's list is sorted best-first: once 32 entries in a row
      // fail the threshold, the rest of the list fails it too.
      if (__ballot_sync(kFull, top.passes(valid, sc, pos)) == 0) break;
      top.push(valid, sc, pos, lane);
    }
  }
  if (top.cnt > 0) top.flush(lane);
  for (int t = lane; t < k; t += 32) {
    const float sc = s[t];
    const int pos = p[t];
    const bool missing = pos == kNoPos || sc == -INFINITY;
    out_s[static_cast<int64_t>(q) * k + t] = missing ? -INFINITY : sc;
    out_p[static_cast<int64_t>(q) * k + t] = missing ? -1 : pos;
  }
}

template <int RQ, bool VEC4>
cudaError_t launch_partial(const float* xb, const float* xq, const int8_t* mask,
                           int nq, int d, int64_t n_scan, int64_t rows_per_split,
                           int splits, int k, int slots, int l2, float* part_s,
                           int* part_p, cudaStream_t stream) {
  constexpr int QT = kWarps * RQ;
  const size_t smem = sizeof(float) * (QT * kDK + kDK * kPad + kNT)
                      + (sizeof(float) + sizeof(int)) * static_cast<size_t>(QT) * slots;
  cudaError_t err = cudaFuncSetAttribute(
      flat_topk_partial<RQ, VEC4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + QT - 1) / QT, splits);
  flat_topk_partial<RQ, VEC4><<<grid, kThreads, smem, stream>>>(
      xb, xq, mask, nq, d, n_scan, rows_per_split, k, slots, l2, part_s, part_p);
  return cudaGetLastError();
}

template <int RQ>
cudaError_t launch_partial_vec(bool vec4, const float* xb, const float* xq,
                               const int8_t* mask, int nq, int d, int64_t n_scan,
                               int64_t rows_per_split, int splits, int k, int slots,
                               int l2, float* part_s, int* part_p,
                               cudaStream_t stream) {
  return vec4 ? launch_partial<RQ, true>(xb, xq, mask, nq, d, n_scan, rows_per_split,
                                         splits, k, slots, l2, part_s, part_p, stream)
              : launch_partial<RQ, false>(xb, xq, mask, nq, d, n_scan, rows_per_split,
                                          splits, k, slots, l2, part_s, part_p, stream);
}

}  // namespace

// Returns the CUDA error of the launches (0 on success).  The caller sizes
// part_s/part_p as (nq, splits, k) and out_s/out_p as (nq, k); rows_per_split
// is a multiple of 128 and splits * rows_per_split >= n_scan.
extern "C" int dfx_flat_topk(const float* xb, const float* xq, const int8_t* mask,
                             int nq, int d, long long n_scan, int k, int l2, int rq,
                             int vec4, int splits, long long rows_per_split,
                             int slots, int merge_warps, float* part_s,
                             int* part_p, float* out_s, int* out_p,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (rq) {
    case 1:
      err = launch_partial_vec<1>(vec4, xb, xq, mask, nq, d, n_scan, rows_per_split,
                                  splits, k, slots, l2, part_s, part_p, stream);
      break;
    case 2:
      err = launch_partial_vec<2>(vec4, xb, xq, mask, nq, d, n_scan, rows_per_split,
                                  splits, k, slots, l2, part_s, part_p, stream);
      break;
    case 4:
      err = launch_partial_vec<4>(vec4, xb, xq, mask, nq, d, n_scan, rows_per_split,
                                  splits, k, slots, l2, part_s, part_p, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t msmem = (sizeof(float) + sizeof(int)) * static_cast<size_t>(merge_warps) * slots;
  err = cudaFuncSetAttribute(flat_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(msmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mblocks = (nq + merge_warps - 1) / merge_warps;
  flat_topk_merge<<<mblocks, 32 * merge_warps, msmem, stream>>>(
      part_s, part_p, nq, splits, k, slots, out_s, out_p);
  return static_cast<int>(cudaGetLastError());
}
