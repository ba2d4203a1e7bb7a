// Dense IVF,SQ8/SQ4 spill scan (K5), for Hopper (sm_90a).  Replaces the TPU
// kernel duckdb_faiss_ext_tpu/ops/pallas_spill.py::_spill_kernel; the
// Python wrapper is duckdb_faiss_ext_tpu_torch/ops/sq_spill.py.
//
// Contract: codes (s_pad, w) uint8 spill rows, assign (s_pad,) list of each
// row, pos (s_pad,) storage row (-1 padding), rs / rn (s_pad,) fp32, optional
// mask (s_pad,) bytes, probe_ids (nq, nprobe), digits (nq, 2, 4 * words)
// int8, qs (nq, 4) fp32 (su2, c0, base, mu).  Rows [0, n_rows) are scanned
// in windows of 128.  A row scores for query q with sq_digits.cuh::score
// when its list is among q's probes, its pos >= 0 and its mask byte is not
// 0; otherwise -inf, as are rows at or past n_rows.  For every query q and
// window v, write wmax[q, v] = the window's largest score and warg[q, v] =
// the first row reaching it (the window's first row when all are -inf).
// The TPU kernel wrote (nwin, nq) for Mosaic's 128-lane block rule; here
// the outputs are (nq, nwin), the orientation the top-k over windows reads.
//
// Design.  The TPU kernel streamed 2048-row payload chunks on a sequential
// grid and scored every query against each chunk in one int8 MXU dot.  Here
// one block of 128 threads serves one (window, group of 8 queries) pair;
// blocks of one window are adjacent in the grid, so a window's rows come
// from device memory once and from L2 for the other query groups.  The
// group's probe ids and hi / lo digits are staged in shared memory; each
// thread owns one row, tests its list against the group's probes, and only
// when some query of the group probes it reads the row in 16-byte units and
// runs 16 __dp4a per code word (sq_digits.cuh).  sq6 spills take the plain
// int8 spill scan, as in the JAX package.  The window's max and first
// argmax per query come from warp shuffles and a 4-warp combine in shared
// memory.
// What bounds it on the H100: __dp4a throughput over the probed rows (16
// per 4 codes), then the spill's code bytes, read once per window.  int8 tensor
// cores and a larger query group per block are left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sq_digits.cuh"

namespace {

constexpr int kQG = 8;          // queries per block
constexpr int kSlots = 2 * kQG;
constexpr int kWin = 128;       // rows per window: one per thread
constexpr int kWarps = kWin / 32;
constexpr unsigned kFull = 0xffffffffu;

// (score, row) a beats b: larger score, then lower row.
__device__ __forceinline__ bool better(float sa, int ra, float sb, int rb) {
  return sa > sb || (sa == sb && ra < rb);
}

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(kWin)
sq_spill_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ assign,
                const int* __restrict__ pos, const float* __restrict__ rs,
                const float* __restrict__ rn, const int8_t* __restrict__ mask,
                const int* __restrict__ probe_ids, const int8_t* __restrict__ digits,
                const float* __restrict__ qs, int nq, int nprobe, int n_rows, int nwin,
                int n_groups, int w, float* __restrict__ wmax, int* __restrict__ warg) {
  extern __shared__ int4 smem4[];
  int* probes = reinterpret_cast<int*>(smem4);  // [kQG][nprobe]
  const int words = sqd::digit_words<CODEC>(w);
  // digits after the probes, 16-byte aligned
  int* dig = probes + ((kQG * nprobe + 3) & ~3);
  __shared__ float red_s[kWarps][kQG];
  __shared__ int red_r[kWarps][kQG];

  const int group = blockIdx.x % n_groups;
  const int win = blockIdx.x / n_groups;
  const int q0 = group * kQG;
  for (int i = threadIdx.x; i < kQG * nprobe; i += kWin) {
    const int q = q0 + i / nprobe;
    probes[i] = q < nq ? probe_ids[static_cast<int64_t>(q) * nprobe + i % nprobe] : -1;
  }
  sqd::stage_digits(digits, q0, nq, kQG, words, dig);
  __syncthreads();

  const int r = win * kWin + threadIdx.x;
  unsigned probed = 0;  // bit q: query q0 + q probes this row's list
  if (r < n_rows && pos[r] >= 0 && (mask == nullptr || mask[r] != 0)) {
    const int a = assign[r];
    for (int q = 0; q < kQG; ++q) {
      const int* pq = probes + q * nprobe;
      for (int j = 0; j < nprobe; ++j) {
        if (pq[j] == a) {
          probed |= 1u << q;
          break;
        }
      }
    }
  }
  float s[kQG];
#pragma unroll
  for (int q = 0; q < kQG; ++q) s[q] = -INFINITY;
  if (probed) {
    int acc[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) acc[i] = 0;
    sqd::row_dot<CODEC, VEC, kSlots>(codes + static_cast<int64_t>(r) * w, w, 0, 1, dig, acc);
    const float rs_r = rs[r];
    const float rn_r = L2 ? rn[r] : 0.f;
#pragma unroll
    for (int q = 0; q < kQG; ++q) {
      if (probed >> q & 1u) {
        const float4 v = reinterpret_cast<const float4*>(qs)[q0 + q];
        s[q] = sqd::score<L2>(acc[2 * q], acc[2 * q + 1], v.x, v.y, v.z, v.w, rs_r, rn_r);
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kQG; ++q) {
    float bs = s[q];
    int br = r;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, off);
      const int orr = __shfl_xor_sync(kFull, br, off);
      if (better(os, orr, bs, br)) {
        bs = os;
        br = orr;
      }
    }
    if (lane == 0) {
      red_s[warp][q] = bs;
      red_r[warp][q] = br;
    }
  }
  __syncthreads();
  if (threadIdx.x < kQG && q0 + threadIdx.x < nq) {
    const int q = threadIdx.x;
    float bs = red_s[0][q];
    int br = red_r[0][q];
    for (int k = 1; k < kWarps; ++k) {
      if (better(red_s[k][q], red_r[k][q], bs, br)) {
        bs = red_s[k][q];
        br = red_r[k][q];
      }
    }
    const int64_t o = static_cast<int64_t>(q0 + q) * nwin + win;
    wmax[o] = bs;
    warg[o] = br;
  }
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch(const uint8_t* codes, const int* assign, const int* pos, const float* rs,
                   const float* rn, const int8_t* mask, const int* probe_ids,
                   const int8_t* digits, const float* qs, int nq, int nprobe, int n_rows,
                   int w, float* wmax, int* warg, cudaStream_t stream) {
  const int nwin = (n_rows + kWin - 1) / kWin;
  const int n_groups = (nq + kQG - 1) / kQG;
  const size_t smem = sizeof(int) * (((kQG * nprobe + 3) & ~3) +
                                     kSlots * static_cast<size_t>(sqd::digit_words<CODEC>(w)));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sq_spill_kernel<CODEC, VEC, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(nwin) * n_groups);
  sq_spill_kernel<CODEC, VEC, L2><<<blocks, kWin, smem, stream>>>(
      codes, assign, pos, rs, rn, mask, probe_ids, digits, qs, nq, nprobe, n_rows, nwin,
      n_groups, w, wmax, warg);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t dispatch(bool vec, bool l2, const uint8_t* codes, const int* assign,
                     const int* pos, const float* rs, const float* rn, const int8_t* mask,
                     const int* probe_ids, const int8_t* digits, const float* qs, int nq,
                     int nprobe, int n_rows, int w, float* wmax, int* warg, cudaStream_t s) {
  if (vec)
    return l2 ? launch<CODEC, true, true>(codes, assign, pos, rs, rn, mask, probe_ids, digits,
                                          qs, nq, nprobe, n_rows, w, wmax, warg, s)
              : launch<CODEC, true, false>(codes, assign, pos, rs, rn, mask, probe_ids, digits,
                                           qs, nq, nprobe, n_rows, w, wmax, warg, s);
  return l2 ? launch<CODEC, false, true>(codes, assign, pos, rs, rn, mask, probe_ids, digits,
                                         qs, nq, nprobe, n_rows, w, wmax, warg, s)
            : launch<CODEC, false, false>(codes, assign, pos, rs, rn, mask, probe_ids, digits,
                                          qs, nq, nprobe, n_rows, w, wmax, warg, s);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or cudaErrorInvalidValue
// for a codec the spill kernel does not take.  codec: 0 sq8, 1 sq4.  The
// caller sizes wmax / warg as (nq, ceil(n_rows / 128)), keeps that window
// count times ceil(nq / 8) below 2^31, and passes vec = 1 only with w a
// multiple of 16 and 16-byte aligned codes; digits must be 4-byte and qs
// 16-byte aligned.
extern "C" int dfx_sq_spill(const uint8_t* codes, const int* assign, const int* pos,
                            const float* rs, const float* rn, const int8_t* mask,
                            const int* probe_ids, const int8_t* digits, const float* qs,
                            int nq, int nprobe, int n_rows, int w, int codec, int l2, int vec,
                            float* wmax, int* warg, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      err = dispatch<sqd::kSQ8>(vec, l2, codes, assign, pos, rs, rn, mask, probe_ids, digits,
                                qs, nq, nprobe, n_rows, w, wmax, warg, s);
      break;
    case sqd::kSQ4:
      err = dispatch<sqd::kSQ4>(vec, l2, codes, assign, pos, rs, rn, mask, probe_ids, digits,
                                qs, nq, nprobe, n_rows, w, wmax, warg, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
