// Per-query IVF,SQ8/SQ4/SQ6 int8 list scan (K2), for Hopper (sm_90a).
// Replaces the TPU kernel duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
// _sq_scan_kernel; the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_sq_scan.py.
//
// Contract: codes (nlist, lmax, w) uint8 packed rows padded per list,
// rn / rs (nlist, lmax) fp32 per-slot sum (scale c)^2 and sum c, counts
// (nlist,), probe_ids (nq, nprobe), digits (nq, 2, 4 * words) int8 (each
// query's hi and lo digits in dimension order, zero past its codes), qs
// (nq, 4) fp32 per-query (su2, c0, base, mu), optional mask (nlist, lmax)
// bytes.  For every (query i, probe slot j) with list l = probe_ids[i, j],
// write out[i, j, r] for every slot r < lmax: the fp32 score of
// sq_digits.cuh::score from the exact digit dots of row r, and -inf where
// r >= counts[l] or mask[l, r] == 0.  Top-k, position resolve and the
// exact fp32 rerank run outside, in torch.
//
// Design.  The TPU kernel DMA'd each probed code block into VMEM from a
// scalar-prefetched probe table and ran a (2, w) x (lmax, w)^T int8 MXU
// dot per sub-tile.  Here, as in K6 (ivf_list_scan.cu), one block of 256
// threads serves one (query, probed list) pair and reads its list id from
// probe_ids on the device.  The query's hi / lo digits (2 x d bytes, 3 KB
// at d = 1536) are staged in shared memory; each warp scores one list row
// at a time, its lanes striding along the row in 16-byte units (48 for
// sq6) that are unpacked in registers and dotted with __dp4a
// (sq_digits.cuh), then a shuffle reduction of the two int32 sums.  Rows at
// or beyond the count are never read; their slots are written -inf.
// Offsets into the codes are 64-bit.
// What bounds it on the H100: the code bytes of the probed lists (count x w
// per pair) and the (nq, nprobe, lmax) score block it writes.  A warp per
// row idles lanes when a row has fewer than 32 units (d = 128 sq8: 8 of
// 32); several rows a warp at small d, tensor-core int8 (mma / wgmma) and a
// fused top-k are left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sq_digits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(kThreads)
ivf_sq_scan_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ rn,
                   const float* __restrict__ rs, const int* __restrict__ counts,
                   const int* __restrict__ probe_ids, const int8_t* __restrict__ digits,
                   const float* __restrict__ qs, const int8_t* __restrict__ mask, int nq,
                   int nprobe, int nlist, int lmax, int w, float* __restrict__ out) {
  extern __shared__ int4 dig_s4[];
  int* dig = reinterpret_cast<int*>(dig_s4);
  const int64_t pair = blockIdx.x;  // query * nprobe + probe slot
  const int qi = static_cast<int>(pair / nprobe);
  const int lid = probe_ids[pair];
  float* o = out + pair * lmax;
  const bool live = lid >= 0 && lid < nlist;
  const int cnt = live ? min(max(counts[lid], 0), lmax) : 0;
  for (int r = cnt + threadIdx.x; r < lmax; r += kThreads) o[r] = -INFINITY;
  if (cnt == 0) return;  // block-uniform
  const int words = sqd::digit_words<CODEC>(w);
  sqd::stage_digits(digits, qi, nq, 1, words, dig);
  __syncthreads();

  const float su2 = qs[qi * 4], c0 = qs[qi * 4 + 1], base = qs[qi * 4 + 2],
              mu = qs[qi * 4 + 3];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t slot0 = static_cast<int64_t>(lid) * lmax;
  for (int r = warp; r < cnt; r += kWarps) {
    if (mask && mask[slot0 + r] == 0) {  // warp-uniform: the warp owns row r
      if (lane == 0) o[r] = -INFINITY;
      continue;
    }
    int acc[2] = {0, 0};
    sqd::row_dot<CODEC, VEC, 2>(codes + (slot0 + r) * w, w, lane, 32, dig, acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[0] += __shfl_xor_sync(kFull, acc[0], off);
      acc[1] += __shfl_xor_sync(kFull, acc[1], off);
    }
    if (lane == 0)
      o[r] = sqd::score<L2>(acc[0], acc[1], su2, c0, base, mu, rs[slot0 + r],
                            L2 ? rn[slot0 + r] : 0.f);
  }
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch(const uint8_t* codes, const float* rn, const float* rs, const int* counts,
                   const int* probe_ids, const int8_t* digits, const float* qs,
                   const int8_t* mask, int nq, int nprobe, int nlist, int lmax, int w,
                   float* out, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(sqd::digit_words<CODEC>(w));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_sq_scan_kernel<CODEC, VEC, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(nq) * nprobe);
  ivf_sq_scan_kernel<CODEC, VEC, L2><<<blocks, kThreads, smem, stream>>>(
      codes, rn, rs, counts, probe_ids, digits, qs, mask, nq, nprobe, nlist, lmax, w, out);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t dispatch(bool vec, bool l2, const uint8_t* codes, const float* rn,
                     const float* rs, const int* counts, const int* probe_ids,
                     const int8_t* digits, const float* qs, const int8_t* mask, int nq,
                     int nprobe, int nlist, int lmax, int w, float* out, cudaStream_t s) {
  if (vec)
    return l2 ? launch<CODEC, true, true>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                          nq, nprobe, nlist, lmax, w, out, s)
              : launch<CODEC, true, false>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                           nq, nprobe, nlist, lmax, w, out, s);
  return l2 ? launch<CODEC, false, true>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                         nq, nprobe, nlist, lmax, w, out, s)
            : launch<CODEC, false, false>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                          nq, nprobe, nlist, lmax, w, out, s);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or cudaErrorInvalidValue
// for an unknown codec.  codec: 0 sq8, 1 sq4, 2 sq6.  The caller sizes out as
// (nq, nprobe, lmax), keeps nq * nprobe below 2^31, and passes vec = 1 only
// with w a multiple of the unit (16 bytes; 48 for sq6) and 16-byte aligned
// codes; digits must be 4-byte aligned.
extern "C" int dfx_ivf_sq_scan(const uint8_t* codes, const float* rn, const float* rs,
                               const int* counts, const int* probe_ids, const int8_t* digits,
                               const float* qs, const int8_t* mask, int nq, int nprobe,
                               int nlist, int lmax, int w, int codec, int l2, int vec,
                               float* out, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      err = dispatch<sqd::kSQ8>(vec, l2, codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                nq, nprobe, nlist, lmax, w, out, s);
      break;
    case sqd::kSQ4:
      err = dispatch<sqd::kSQ4>(vec, l2, codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                nq, nprobe, nlist, lmax, w, out, s);
      break;
    case sqd::kSQ6:
      err = dispatch<sqd::kSQ6>(vec, l2, codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                nq, nprobe, nlist, lmax, w, out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
