// Pair-tile IVF,Flat scan (K7), for Hopper (sm_90a).  Replaces the TPU
// kernel duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::_pairs_flat_kernel;
// the Python wrapper is duckdb_faiss_ext_tpu_torch/ops/ivf_pairs.py.
//
// Contract: lists (nlist, lmax, d) fp32 padded per list, counts (nlist,),
// xq_t (t_max, 8, d) the tiles' queries, qs (t_max, 8, 4) each slot's
// (bias, |q|^2, 0, 0) with bias -inf on empty slots, meta (1 + t_max,) =
// n_tiles followed by each tile's list id, optional mask (nlist, lmax)
// bytes.  For every tile t < n_tiles with list l = meta[1 + t], query slot
// s and row r < lmax:
//   IP: x_r . q_s + bias_s      L2: -max(|q_s|^2 - 2 x_r . q_s + |x_r|^2, 0) + bias_s
// and -inf where r >= counts[l] or mask[l, r] == 0.  Tiles t >= n_tiles
// return at once and are left unwritten (no pair points into them);
// n_tiles is read on the device, so the host never waits for it.
//
// Design.  The TPU kernel DMA'd one list block per tile and ran one
// (8, d) x (lmax, d)^T product on the MXU.  Here one block of 256 threads
// serves one tile: it streams the list block through shared memory in
// chunks of 256 rows x 32 dims (16-byte loads when d % 4 == 0, stored with
// a 33-float row stride so the per-thread row reads hit 32 banks), and the
// 8 queries' matching 32 dims beside them.  Each thread owns one list row
// and keeps the 8 dot products and the row's squared norm in registers, so
// every list row is read from device memory once per tile for 8 queries.
// Sums are fp32 FMAs (no TF32), in the expansion form the TPU kernel used;
// the epilogue re-scores the selected candidates in difference form.
// Offsets into the payload are 64-bit (lid * lmax * d passes 2^31 at
// realistic sizes).
// What bounds it on the H100: fp32 FMA throughput (8 x lmax x d per tile) and
// the shared-memory reads feeding it (one row value and two 16-byte query
// broadcasts per 9 FMAs).  Tensor cores (TF32 / 3xTF32), cp.async or TMA
// double buffering of the chunks, and several tiles of one list per block
// are left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQG = 8;        // queries per tile
constexpr int kRows = 256;    // list rows per chunk: one per thread
constexpr int kDK = 32;       // dims per staged chunk
constexpr int kStride = kDK + 1;
static_assert(kRows == kQG * kDK, "each thread stages one query value a chunk");

template <bool VEC4, bool L2>
__global__ void __launch_bounds__(kRows)
ivf_pairs_kernel(const float* __restrict__ lists, const int* __restrict__ counts,
                 const float* __restrict__ xq_t, const float* __restrict__ qs,
                 const int* __restrict__ meta, const int8_t* __restrict__ mask,
                 int nlist, int lmax, int d, float* __restrict__ out) {
  __shared__ float xs[kRows * kStride];
  __shared__ float4 q_s[kDK][kQG / 4];  // [dim][query]: two broadcasts a dim

  const int tile = blockIdx.x;
  if (tile >= meta[0]) return;  // padding tile: block-uniform
  const int lid = meta[1 + tile];
  const bool live = lid >= 0 && lid < nlist;
  const int cnt = live ? min(max(counts[lid], 0), lmax) : 0;
  float* o = out + static_cast<int64_t>(tile) * kQG * lmax;
  const float* base = lists + static_cast<int64_t>(live ? lid : 0) * lmax * d;
  const float* qt = xq_t + static_cast<int64_t>(tile) * kQG * d;
  const int8_t* mrow = mask ? mask + static_cast<int64_t>(live ? lid : 0) * lmax : nullptr;
  float bias[kQG], qn[kQG];
#pragma unroll
  for (int q = 0; q < kQG; ++q) {
    bias[q] = qs[(static_cast<int64_t>(tile) * kQG + q) * 4];
    qn[q] = qs[(static_cast<int64_t>(tile) * kQG + q) * 4 + 1];
  }

  for (int row0 = 0; row0 < lmax; row0 += kRows) {
    const int r = row0 + threadIdx.x;
    if (row0 >= cnt) {  // block-uniform: nothing of this chunk is valid
      if (r < lmax) {
#pragma unroll
        for (int q = 0; q < kQG; ++q) o[q * lmax + r] = -INFINITY;
      }
      continue;
    }
    float acc[kQG];
#pragma unroll
    for (int q = 0; q < kQG; ++q) acc[q] = 0.f;
    float bn = 0.f;
    for (int k0 = 0; k0 < d; k0 += kDK) {
      __syncthreads();  // the previous chunk's readers are done
      if (VEC4) {
        for (int idx = threadIdx.x; idx < kRows * (kDK / 4); idx += kRows) {
          const int rr = idx / (kDK / 4);
          const int col = k0 + (idx % (kDK / 4)) * 4;
          const int row = row0 + rr;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < cnt && col < d)
            v = __ldg(reinterpret_cast<const float4*>(base + static_cast<int64_t>(row) * d + col));
          float* dst = xs + rr * kStride + (col - k0);
          dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
        }
      } else {
        for (int idx = threadIdx.x; idx < kRows * kDK; idx += kRows) {
          const int rr = idx / kDK;
          const int col = k0 + idx % kDK;
          const int row = row0 + rr;
          xs[rr * kStride + (col - k0)] =
              (row < cnt && col < d) ? __ldg(base + static_cast<int64_t>(row) * d + col) : 0.f;
        }
      }
      {  // the 8 queries' dims [k0, k0 + 32): one value a thread
        const int q = threadIdx.x / kDK;
        const int c = threadIdx.x % kDK;
        reinterpret_cast<float*>(q_s)[c * kQG + q] =
            (k0 + c < d) ? qt[static_cast<int64_t>(q) * d + k0 + c] : 0.f;
      }
      __syncthreads();
      const float* xrow = xs + threadIdx.x * kStride;
#pragma unroll 8
      for (int c = 0; c < kDK; ++c) {  // zero padding adds nothing
        const float x = xrow[c];
        const float4 qa = q_s[c][0];
        const float4 qb = q_s[c][1];
        acc[0] = fmaf(x, qa.x, acc[0]);
        acc[1] = fmaf(x, qa.y, acc[1]);
        acc[2] = fmaf(x, qa.z, acc[2]);
        acc[3] = fmaf(x, qa.w, acc[3]);
        acc[4] = fmaf(x, qb.x, acc[4]);
        acc[5] = fmaf(x, qb.y, acc[5]);
        acc[6] = fmaf(x, qb.z, acc[6]);
        acc[7] = fmaf(x, qb.w, acc[7]);
        bn = fmaf(x, x, bn);
      }
    }
    if (r < lmax) {
      const bool valid = r < cnt && (mrow == nullptr || mrow[r] != 0);
#pragma unroll
      for (int q = 0; q < kQG; ++q) {
        float s = -INFINITY;
        if (valid) s = L2 ? -fmaxf(qn[q] - 2.f * acc[q] + bn, 0.f) + bias[q] : acc[q] + bias[q];
        o[q * lmax + r] = s;
      }
    }
  }
}

template <bool VEC4, bool L2>
cudaError_t launch(const float* lists, const int* counts, const float* xq_t,
                   const float* qs, const int* meta, const int8_t* mask, int t_max,
                   int nlist, int lmax, int d, float* out, cudaStream_t stream) {
  ivf_pairs_kernel<VEC4, L2><<<t_max, kRows, 0, stream>>>(
      lists, counts, xq_t, qs, meta, mask, nlist, lmax, d, out);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The caller sizes out
// as (t_max, 8, lmax); vec4 needs d % 4 == 0 and 16-byte aligned lists.
extern "C" int dfx_ivf_pairs(const float* lists, const int* counts, const float* xq_t,
                             const float* qs, const int* meta, const int8_t* mask,
                             int t_max, int nlist, int lmax, int d, int l2, int vec4,
                             float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (vec4) {
    err = l2 ? launch<true, true>(lists, counts, xq_t, qs, meta, mask, t_max, nlist, lmax,
                                  d, out, stream)
             : launch<true, false>(lists, counts, xq_t, qs, meta, mask, t_max, nlist, lmax,
                                   d, out, stream);
  } else {
    err = l2 ? launch<false, true>(lists, counts, xq_t, qs, meta, mask, t_max, nlist, lmax,
                                   d, out, stream)
             : launch<false, false>(lists, counts, xq_t, qs, meta, mask, t_max, nlist,
                                    lmax, d, out, stream);
  }
  return static_cast<int>(err);
}
