// Per-query IVF,Flat list scan (K6), for Hopper (sm_90a).  Replaces the TPU
// kernel duckdb_faiss_ext_tpu/ops/pallas_ivf.py::_scan_kernel; the Python
// wrapper is duckdb_faiss_ext_tpu_torch/ops/ivf_list_scan.py.
//
// Contract: lists (nlist, lmax, d) fp32 padded per list, counts (nlist,),
// probe_ids (nq, nprobe), xq (nq, d), optional mask (nlist, lmax) bytes.
// For every (query i, probe slot j) with list l = probe_ids[i, j], write
// out[i, j, r] for every slot r < lmax:
//   IP: x_r . q        L2: -sum_d (x_r - q)^2   (difference form, as the
//   TPU kernel computes it: the expansion form cancels differently and
//   would move near-ties)
// and -inf where r >= counts[l] or mask[l, r] == 0.  Top-k and position
// resolve run outside, in torch.
//
// Design.  The TPU kernel DMA'd each probed (lmax, d) block into VMEM from
// a scalar-prefetched probe table and scored it in one vector pass.  Here
// one block of 256 threads serves one (query, probed list) pair: it reads
// its list id from probe_ids on the device (no host round trip), stages the
// query in shared memory, and each warp scores one list row at a time with
// its lanes along d (16-byte loads when d % 4 == 0) and a shuffle
// reduction.  Rows at or beyond the count are never read; their slots are
// written -inf.  Offsets into the payload are 64-bit: lid * lmax * d passes
// 2^31 at realistic sizes (4096 lists x lmax 1024 x d 1536).
// What bounds it on the H100: the bytes of the probed lists (count x d x 4
// per pair, from L2 when several queries of a batch probe one list) and
// the (nq, nprobe, lmax) score block it writes.  At small d most lanes of
// a warp idle (d = 8 uses 2 of 32); a row-group layout for small d, and a
// fused top-k on flat_topk.cu's split-and-merge model so the score block
// never reaches device memory, are left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool VEC4, bool L2>
__global__ void __launch_bounds__(kThreads)
ivf_list_scan_kernel(const float* __restrict__ lists, const int* __restrict__ counts,
                     const int* __restrict__ probe_ids, const float* __restrict__ xq,
                     const int8_t* __restrict__ mask, int nprobe, int nlist, int lmax,
                     int d, float* __restrict__ out) {
  extern __shared__ float4 q_s4[];
  float* q_s = reinterpret_cast<float*>(q_s4);
  const int64_t pair = blockIdx.x;  // query * nprobe + probe slot
  const int64_t qi = pair / nprobe;
  const int lid = probe_ids[pair];
  float* o = out + pair * lmax;
  const bool live = lid >= 0 && lid < nlist;
  const int cnt = live ? min(max(counts[lid], 0), lmax) : 0;
  for (int r = cnt + threadIdx.x; r < lmax; r += kThreads) o[r] = -INFINITY;
  if (cnt == 0) return;  // block-uniform
  for (int j = threadIdx.x; j < d; j += kThreads) q_s[j] = xq[qi * d + j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* base = lists + static_cast<int64_t>(lid) * lmax * d;
  const int8_t* mrow = mask ? mask + static_cast<int64_t>(lid) * lmax : nullptr;
  for (int r = warp; r < cnt; r += kWarps) {
    if (mrow && mrow[r] == 0) {  // warp-uniform: the warp owns row r
      if (lane == 0) o[r] = -INFINITY;
      continue;
    }
    const float* x = base + static_cast<int64_t>(r) * d;
    float acc = 0.f;
    if (VEC4) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      for (int j = lane; j < (d >> 2); j += 32) {
        const float4 a = __ldg(x4 + j);
        const float4 b = q_s4[j];
        if (L2) {
          float t = a.x - b.x; acc = fmaf(t, t, acc);
          t = a.y - b.y; acc = fmaf(t, t, acc);
          t = a.z - b.z; acc = fmaf(t, t, acc);
          t = a.w - b.w; acc = fmaf(t, t, acc);
        } else {
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float a = __ldg(x + j);
        const float b = q_s[j];
        if (L2) {
          const float t = a - b;
          acc = fmaf(t, t, acc);
        } else {
          acc = fmaf(a, b, acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) o[r] = L2 ? -acc : acc;
  }
}

template <bool VEC4, bool L2>
cudaError_t launch(const float* lists, const int* counts, const int* probe_ids,
                   const float* xq, const int8_t* mask, int nq, int nprobe, int nlist,
                   int lmax, int d, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>((d + 3) / 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_list_scan_kernel<VEC4, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(nq) * nprobe);
  ivf_list_scan_kernel<VEC4, L2><<<blocks, kThreads, smem, stream>>>(
      lists, counts, probe_ids, xq, mask, nprobe, nlist, lmax, d, out);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The caller sizes out
// as (nq, nprobe, lmax) and keeps nq * nprobe below 2^31; vec4 needs d % 4 == 0
// and 16-byte aligned lists and xq.
extern "C" int dfx_ivf_list_scan(const float* lists, const int* counts,
                                 const int* probe_ids, const float* xq,
                                 const int8_t* mask, int nq, int nprobe, int nlist,
                                 int lmax, int d, int l2, int vec4, float* out,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (vec4) {
    err = l2 ? launch<true, true>(lists, counts, probe_ids, xq, mask, nq, nprobe, nlist,
                                  lmax, d, out, stream)
             : launch<true, false>(lists, counts, probe_ids, xq, mask, nq, nprobe, nlist,
                                   lmax, d, out, stream);
  } else {
    err = l2 ? launch<false, true>(lists, counts, probe_ids, xq, mask, nq, nprobe, nlist,
                                   lmax, d, out, stream)
             : launch<false, false>(lists, counts, probe_ids, xq, mask, nq, nprobe, nlist,
                                    lmax, d, out, stream);
  }
  return static_cast<int>(err);
}
