// IVF,SQ8/SQ4 spill search (K5), for Hopper (sm_90a): the window scan and
// the fp32 rescore of the rows it selects.  Replaces the TPU kernel
// duckdb_faiss_ext_tpu/ops/pallas_spill.py::_spill_kernel and the rerank
// legs around it (pallas_spill_search, :284-360); the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/sq_spill.py.
//
// The spill region: codes (s_pad, w) uint8 rows sorted by list, assign
// (s_pad,) list of each row, pos (s_pad,) storage row (-1 padding), rs / rn
// (s_pad,) fp32, optional mask (s_pad,) bytes, and offsets (nlist + 1,)
// int64: list l's spill rows are [offsets[l], offsets[l + 1]).
//
// (1) Windows.  For every query q and 128-row window v of the first n_rows
// rows, wmax[q, v] = the largest score of the window's rows that are valid
// for q (list among q's probes, pos >= 0, mask byte not 0), scored with
// sq_digits.cuh::score from exact int32 digit dots, and warg[q, v] = the
// first row reaching it; a window with no valid row keeps (-inf, its first
// row).  The TPU kernel (and the first port) scored every window against
// every query group and found almost nothing to score: a group of 8
// queries probes at most 128 of 4096 lists.  Here the unit of work is a
// (query, probe): its rows are the probed list's spill range, read once for
// that query and dotted against its hi / lo digits (__dp4a).  A block of
// 128 threads walks the range's 128-row windows, a thread a row; kSplit
// blocks share a unit, taking every kSplit-th window, so the longest lists
// (12k spill rows at 8.8M x 1536) spread over several SMs.  Units are
// visited in list order (the wrapper's `units`), so the queries of one list
// run side by side and its codes come from L2.  Two probes of a query can
// touch one window (where one list ends and the next begins), so a window
// folds its (score, row) into a 64-bit key, the score's order-preserving
// bits above the complement of the row, with atomicMax: the larger score
// wins, then the lower row, as torch's first argmax.  A block reduces its
// 128 rows to one key first.  A second launch turns the keys into (wmax,
// warg).  Integer dots and the unfused epilogue keep the outputs bit-equal
// to the plain version (-0.0 and +0.0 share a key; they compare equal).
//
// (2) Rescore.  For query q and candidate j of its kw windows (the rows
// wsel[q, j / 128] * 128 + j % 128) and nt window argmaxes (the rows
// warg[q, wsel[q, kw + i]]), a valid row is decoded in registers as
// ops/sq.py::sq_decode does (c * scale + vmin, __fmul_rn then __fadd_rn)
// and scored in fp32: IP x.q, L2 -max(|q|^2 - 2 x.q + |x|^2, 0); an invalid
// row (past n_rows, pos < 0, masked, list not probed) scores -inf.  A warp
// scores a row, its lanes taking the row's code words; a block holds one
// query's vector, scale and vmin in shared memory and scores 128 rows.
//
// What bounds it on the H100: device memory.  The windows read each probed
// list's spill codes (the whole spill, 231,766 x 1536 B = 356 MB at the
// MS MARCO shape, is 0.11 ms); the rescore reads at most nq x (kw x 128 +
// nt) rows (2.4 GB at b1024, 0.72 ms), fewer where rows are not valid.
// sq6 spills take the plain int8 spill scan, as in the JAX package.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sq_digits.cuh"

namespace {

constexpr int kWin = 128;     // rows per window: one per thread
constexpr int kSplit = 4;     // blocks sharing a (query, probe)
constexpr int kRescoreThreads = 256;
constexpr int kRescoreRows = 128;  // rows a rescore block scores
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving bits of a finite score (+0.0 for -0.0).
__device__ __forceinline__ uint32_t ordered(float s) {
  const uint32_t u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(kWin)
sq_spill_windows_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ pos,
                        const float* __restrict__ rs, const float* __restrict__ rn,
                        const int8_t* __restrict__ mask, const long long* __restrict__ offsets,
                        const int* __restrict__ probe_ids, const int* __restrict__ units,
                        const int8_t* __restrict__ digits, const float* __restrict__ qs,
                        int nq, int nprobe, int n_rows, int nwin, int w,
                        unsigned long long* __restrict__ keys) {
  extern __shared__ int4 smem4[];
  int* dig = reinterpret_cast<int*>(smem4);  // [word][hi, lo]
  __shared__ unsigned long long red[kWin / 32];

  const int unit = units[blockIdx.x];
  const int q = unit / nprobe;
  const int list = probe_ids[unit];
  const long long a = offsets[list];
  long long b = offsets[list + 1];
  if (b > n_rows) b = n_rows;
  if (a >= b) return;  // block-uniform
  const int w0 = static_cast<int>(a / kWin);
  const int w1 = static_cast<int>((b - 1) / kWin);
  if (w0 + static_cast<int>(blockIdx.y) > w1) return;

  sqd::stage_digits(digits, q, nq, 1, sqd::digit_words<CODEC>(w), dig);
  __syncthreads();
  const float4 v = reinterpret_cast<const float4*>(qs)[q];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int win = w0 + blockIdx.y; win <= w1; win += kSplit) {
    const long long r = static_cast<long long>(win) * kWin + threadIdx.x;
    unsigned long long key = 0;  // below every valid row's key
    if (r >= a && r < b && pos[r] >= 0 && (mask == nullptr || mask[r] != 0)) {
      int acc[2] = {0, 0};
      sqd::row_dot<CODEC, VEC, 2>(codes + r * w, w, 0, 1, dig, acc);
      const float s = sqd::score<L2>(acc[0], acc[1], v.x, v.y, v.z, v.w, rs[r],
                                     L2 ? rn[r] : 0.f);
      key = static_cast<unsigned long long>(ordered(s)) << 32 |
            static_cast<uint32_t>(~static_cast<uint32_t>(r));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, key, off);
      key = o > key ? o : key;
    }
    if (lane == 0) red[warp] = key;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long best = red[0];
      for (int i = 1; i < kWin / 32; ++i) best = red[i] > best ? red[i] : best;
      if (best) atomicMax(keys + static_cast<long long>(q) * nwin + win, best);
    }
    __syncthreads();  // red is written again next window
  }
}

// keys (nq, nwin) -> (wmax, warg); a zero key: (-inf, the window's first row).
__global__ void sq_spill_decode_kernel(const unsigned long long* __restrict__ keys, long long total,
                                       int nwin, float* __restrict__ wmax,
                                       int* __restrict__ warg) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned long long key = keys[i];
  if (key == 0) {
    wmax[i] = -INFINITY;
    warg[i] = static_cast<int>(i % nwin) * kWin;
  } else {
    wmax[i] = unordered(static_cast<uint32_t>(key >> 32));
    warg[i] = static_cast<int>(~static_cast<uint32_t>(key));
  }
}

// Accumulate one code byte (sq8: one dim; sq4: dims 2b, 2b + 1 below d).
template <int CODEC>
__device__ __forceinline__ void dot_byte(uint32_t byte, int b, int d, const float* xq,
                                         const float* scale, const float* vmin, float& xy,
                                         float& xx) {
  if (CODEC == sqd::kSQ8) {
    const float x = sqd::decode(byte, scale, vmin, b);
    xy = fmaf(x, xq[b], xy);
    xx = fmaf(x, x, xx);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dim = 2 * b + h;
      if (dim < d) {
        const float x = sqd::decode((byte >> (4 * h)) & 15u, scale, vmin, dim);
        xy = fmaf(x, xq[dim], xy);
        xx = fmaf(x, x, xx);
      }
    }
  }
}

template <int CODEC, bool WORDS, bool L2>
__global__ void __launch_bounds__(kRescoreThreads)
sq_spill_rescore_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ assign,
                        const int* __restrict__ pos, const int8_t* __restrict__ mask,
                        const int* __restrict__ probe_ids, const float* __restrict__ xq,
                        const float* __restrict__ vmin, const float* __restrict__ scale,
                        const long long* __restrict__ wsel, const int* __restrict__ warg,
                        int nprobe, int n_rows, int nwin, int k_scan, int kw, int d, int w,
                        float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // d
  float* sc_s = q_s + d;                         // d
  float* vm_s = sc_s + d;                        // d
  int* pr_s = reinterpret_cast<int*>(vm_s + d);  // nprobe
  __shared__ float qn_s;

  const int q = blockIdx.x;
  const int n_out = kw * kWin + (k_scan - kw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < d; i += kRescoreThreads) {
    q_s[i] = xq[static_cast<long long>(q) * d + i];
    sc_s[i] = scale[i];
    vm_s[i] = vmin[i];
  }
  for (int i = threadIdx.x; i < nprobe; i += kRescoreThreads)
    pr_s[i] = probe_ids[static_cast<long long>(q) * nprobe + i];
  __syncthreads();
  if (L2 && warp == 0) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc = fmaf(q_s[i], q_s[i], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) qn_s = acc;
  }
  __syncthreads();

  const long long* sel = wsel + static_cast<long long>(q) * k_scan;
  const int j_end = min(n_out, static_cast<int>(blockIdx.y + 1) * kRescoreRows);
  for (int j = blockIdx.y * kRescoreRows + warp; j < j_end; j += kRescoreThreads / 32) {
    long long r = j < kw * kWin
                      ? sel[j / kWin] * kWin + j % kWin
                      : warg[static_cast<long long>(q) * nwin + sel[kw + j - kw * kWin]];
    bool ok = r >= 0 && r < n_rows && pos[r] >= 0 && (mask == nullptr || mask[r] != 0);
    if (ok) {
      const int list = assign[r];
      bool found = false;
      for (int i = 0; i < nprobe; ++i) found |= pr_s[i] == list;
      ok = found;
    }
    float score = -INFINITY;
    if (ok) {  // warp-uniform
      const uint8_t* row = codes + r * w;
      float xy = 0.f, xx = 0.f;
      if (WORDS) {  // w a multiple of 4, rows 4-byte aligned
        const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
        for (int t = lane; t < w / 4; t += 32) {
          const uint32_t word = __ldg(row4 + t);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dot_byte<CODEC>((word >> (8 * i)) & 0xffu, 4 * t + i, d, q_s, sc_s, vm_s, xy, xx);
        }
      } else {
        for (int t = lane; t < w; t += 32)
          dot_byte<CODEC>(__ldg(row + t), t, d, q_s, sc_s, vm_s, xy, xx);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        xy += __shfl_xor_sync(kFull, xy, off);
        xx += __shfl_xor_sync(kFull, xx, off);
      }
      score = L2 ? -fmaxf(__fadd_rn(__fsub_rn(qn_s, __fmul_rn(2.f, xy)), xx), 0.f) : xy;
    }
    if (lane == 0) out[static_cast<long long>(q) * n_out + j] = score;
  }
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch_windows(const uint8_t* codes, const int* pos, const float* rs,
                           const float* rn, const int8_t* mask, const long long* offsets,
                           const int* probe_ids, const int* units, const int8_t* digits,
                           const float* qs, int nq, int nprobe, int n_rows, int w,
                           unsigned long long* keys, float* wmax, int* warg,
                           cudaStream_t stream) {
  const int nwin = (n_rows + kWin - 1) / kWin;
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(sqd::digit_words<CODEC>(w));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(sq_spill_windows_kernel<CODEC, VEC, L2>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nq) * nprobe, kSplit);
  sq_spill_windows_kernel<CODEC, VEC, L2><<<grid, kWin, smem, stream>>>(
      codes, pos, rs, rn, mask, offsets, probe_ids, units, digits, qs, nq, nprobe, n_rows, nwin,
      w, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(nq) * nwin;
  sq_spill_decode_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      keys, total, nwin, wmax, warg);
  return cudaGetLastError();
}

template <int CODEC, bool WORDS, bool L2>
cudaError_t launch_rescore(const uint8_t* codes, const int* assign, const int* pos,
                           const int8_t* mask, const int* probe_ids, const float* xq,
                           const float* vmin, const float* scale, const long long* wsel,
                           const int* warg, int nq, int nprobe, int n_rows, int nwin, int k_scan,
                           int kw, int d, int w, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(d) + sizeof(int) * nprobe;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(sq_spill_rescore_kernel<CODEC, WORDS, L2>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_out = kw * kWin + (k_scan - kw);
  const dim3 grid(nq, (n_out + kRescoreRows - 1) / kRescoreRows);
  sq_spill_rescore_kernel<CODEC, WORDS, L2><<<grid, kRescoreThreads, smem, stream>>>(
      codes, assign, pos, mask, probe_ids, xq, vmin, scale, wsel, warg, nprobe, n_rows, nwin,
      k_scan, kw, d, w, out);
  return cudaGetLastError();
}

}  // namespace

// The window scan: returns the CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for a codec it does not take.  codec: 0 sq8, 1 sq4.
// The caller passes keys (nq, nwin) zeroed, wmax / warg (nq, nwin) with nwin
// = ceil(n_rows / 128), units: a permutation of the nq * nprobe (query,
// probe) slots (row-major in probe_ids), and vec = 1 only with w a multiple
// of 16 and 16-byte aligned codes; digits must be 4-byte and qs 16-byte
// aligned, and nq * nprobe below 2^31.
extern "C" int dfx_sq_spill_windows(const uint8_t* codes, const int* pos, const float* rs,
                                    const float* rn, const int8_t* mask,
                                    const long long* offsets, const int* probe_ids,
                                    const int* units, const int8_t* digits, const float* qs,
                                    int nq, int nprobe, int n_rows, int w, int codec, int l2,
                                    int vec, unsigned long long* keys, float* wmax, int* warg,
                                    void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define DFX_WINDOWS(C, V, L)                                                                  \
  launch_windows<C, V, L>(codes, pos, rs, rn, mask, offsets, probe_ids, units, digits, qs, nq, \
                          nprobe, n_rows, w, keys, wmax, warg, s)
#define DFX_WINDOWS_VL(C)                                                                  \
  (vec ? (l2 ? DFX_WINDOWS(C, true, true) : DFX_WINDOWS(C, true, false))                   \
       : (l2 ? DFX_WINDOWS(C, false, true) : DFX_WINDOWS(C, false, false)))
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      err = DFX_WINDOWS_VL(sqd::kSQ8);
      break;
    case sqd::kSQ4:
      err = DFX_WINDOWS_VL(sqd::kSQ4);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef DFX_WINDOWS_VL
#undef DFX_WINDOWS
  return static_cast<int>(err);
}

// The rescore: out (nq, kw * 128 + k_scan - kw) fp32; wsel (nq, k_scan)
// int64 window indices below nwin, warg (nq, nwin) int32; words = 1 only
// with w a multiple of 4 and 4-byte aligned codes.  Returns the CUDA error
// of the launch (0 on success), or cudaErrorInvalidValue for a codec it
// does not take.
extern "C" int dfx_sq_spill_rescore(const uint8_t* codes, const int* assign, const int* pos,
                                    const int8_t* mask, const int* probe_ids, const float* xq,
                                    const float* vmin, const float* scale,
                                    const long long* wsel, const int* warg, int nq, int nprobe,
                                    int n_rows, int nwin, int k_scan, int kw, int d, int w,
                                    int codec, int l2, int words, float* out,
                                    void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define DFX_RESCORE(C, W, L)                                                                  \
  launch_rescore<C, W, L>(codes, assign, pos, mask, probe_ids, xq, vmin, scale, wsel, warg, nq, \
                          nprobe, n_rows, nwin, k_scan, kw, d, w, out, s)
#define DFX_RESCORE_WL(C)                                                                  \
  (words ? (l2 ? DFX_RESCORE(C, true, true) : DFX_RESCORE(C, true, false))                 \
         : (l2 ? DFX_RESCORE(C, false, true) : DFX_RESCORE(C, false, false)))
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      err = DFX_RESCORE_WL(sqd::kSQ8);
      break;
    case sqd::kSQ4:
      err = DFX_RESCORE_WL(sqd::kSQ4);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef DFX_RESCORE_WL
#undef DFX_RESCORE
  return static_cast<int>(err);
}
