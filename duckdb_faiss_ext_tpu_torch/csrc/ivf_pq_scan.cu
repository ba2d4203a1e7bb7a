// IVF-PQ / IVF-RQ list scan (K8), for Hopper (sm_90a).  Replaces the TPU
// kernel duckdb_faiss_ext_tpu/ops/pallas_ivf.py::_gather_kernel (wrapper
// pallas_gather_lists, caller pallas_ivf_pq_search); the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_pq_scan.py.
//
// Contract: lists (nlist, lmax, m) uint8 byte codes padded per list, counts
// (nlist,), probe_ids (nq, nprobe), xq (nq, d), centroids (nlist, d),
// codebooks (m, ksub, dsub) for PQ (m * dsub == d) or (m, ksub, d) for RQ,
// optional mask (nlist, lmax) bytes.  For every (query i, probe slot j) with
// list l = probe_ids[i, j], write out[i, j, r] for every slot r < lmax, the
// row decoded by residual as x = dec(code) + centroid[l]:
//   PQ: dec_t = cb[t / dsub][code[t / dsub]][t % dsub]
//   RQ: dec_t = sum_s cb[s][code_s][t], summed in stage order s = 0 .. m-1
//   IP: x . q        L2: -sum_t (x_t - q_t)^2   (difference form)
// and -inf where r >= counts[l] or mask[l, r] == 0.  Top-k, the position
// resolve and the spill merge run outside, in torch.
//
// Design.  The TPU kernel only DMA'd the probed (lmax, m) code blocks into a
// compact buffer; XLA decoded and scored that buffer afterwards.  Here the
// gather, the decode and the score are one pass, so neither the gathered
// codes nor the decoded rows reach device memory.  One block of 256 threads
// serves one (query, probed list) pair: it reads its list id from probe_ids
// on the device, stages the query and the list's centroid in shared memory
// (for PQ also, per dimension t, the subspace t / dsub and the codebook
// offset of t, so no lane divides in the row loop), and each warp scores one
// list row at a time: its lanes read the row's m code bytes once into the
// warp's shared slot, then take dimensions t, t + 32, ..., decode in
// registers (the codebook entries come from device memory through L2: PQ16
// at d = 128 is 128 KB, RQ8x8 at d = 128 1 MB), and end with a shuffle
// reduction.  Rows at or beyond the count are never read; their slots are
// written -inf.  Codes index the codebook as code & (ksub - 1): codes are
// below ksub by construction, and the mask keeps a damaged code inside the
// codebook.  Offsets into the codes, the codebooks and the output are
// 64-bit (b1024 x nprobe 64 x lmax 1536 is 100M output floats).
// What bounds it on the H100: writing the (nq, nprobe, lmax) score block;
// the codes read are lmax x m bytes a pair.  At small d most lanes idle;
// faiss's per-(query, list) m x ksub distance table (LUT-ADC), staging the
// PQ codebook in shared memory, and a fused top-k so the score block never
// reaches device memory are left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool RQ, bool L2>
__global__ void __launch_bounds__(kThreads)
ivf_pq_scan_kernel(const uint8_t* __restrict__ lists, const int* __restrict__ counts,
                   const int* __restrict__ probe_ids, const float* __restrict__ xq,
                   const float* __restrict__ centroids, const float* __restrict__ codebooks,
                   const int8_t* __restrict__ mask, int nprobe, int nlist, int lmax, int m,
                   int d, int ksub, int dsub, int mpad, float* __restrict__ out) {
  // Shared: q (d f32), centroid (d f32), PQ only: offset and subspace of each
  // dimension (d i32 each), then one mpad-byte code slot per warp.
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* c_s = q_s + d;
  int* off_s = reinterpret_cast<int*>(c_s + d);
  int* sub_s = off_s + (RQ ? 0 : d);
  uint8_t* code_all = reinterpret_cast<uint8_t*>(sub_s + (RQ ? 0 : d));

  const int64_t pair = blockIdx.x;  // query * nprobe + probe slot
  const int64_t qi = pair / nprobe;
  const int lid = probe_ids[pair];
  float* o = out + pair * lmax;
  const bool live = lid >= 0 && lid < nlist;
  const int cnt = live ? min(max(counts[lid], 0), lmax) : 0;
  for (int r = cnt + threadIdx.x; r < lmax; r += kThreads) o[r] = -INFINITY;
  if (cnt == 0) return;  // block-uniform
  for (int t = threadIdx.x; t < d; t += kThreads) {
    q_s[t] = xq[qi * d + t];
    c_s[t] = centroids[static_cast<int64_t>(lid) * d + t];
    if (!RQ) {
      const int sub = t / dsub;
      sub_s[t] = sub;
      off_s[t] = sub * ksub * dsub + (t - sub * dsub);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kmask = ksub - 1;
  uint8_t* code_s = code_all + warp * mpad;
  const uint8_t* base = lists + static_cast<int64_t>(lid) * lmax * m;
  const int8_t* mrow = mask ? mask + static_cast<int64_t>(lid) * lmax : nullptr;
  for (int r = warp; r < cnt; r += kWarps) {
    if (mrow && mrow[r] == 0) {  // warp-uniform: the warp owns row r
      if (lane == 0) o[r] = -INFINITY;
      continue;
    }
    const uint8_t* row = base + static_cast<int64_t>(r) * m;
    for (int i = lane; i < m; i += 32) code_s[i] = row[i];
    __syncwarp();
    float acc = 0.f;
    for (int t = lane; t < d; t += 32) {
      float dec;
      if (RQ) {
        dec = 0.f;
        for (int s = 0; s < m; ++s) {
          const int64_t e = static_cast<int64_t>(s) * ksub + (code_s[s] & kmask);
          dec += __ldg(codebooks + e * d + t);
        }
      } else {
        dec = __ldg(codebooks + off_s[t] + (code_s[sub_s[t]] & kmask) * dsub);
      }
      const float x = dec + c_s[t];
      if (L2) {
        const float u = x - q_s[t];
        acc = fmaf(u, u, acc);
      } else {
        acc = fmaf(x, q_s[t], acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) o[r] = L2 ? -acc : acc;
    __syncwarp();  // the next row rewrites code_s
  }
}

template <bool RQ, bool L2>
cudaError_t launch(const uint8_t* lists, const int* counts, const int* probe_ids,
                   const float* xq, const float* centroids, const float* codebooks,
                   const int8_t* mask, int nq, int nprobe, int nlist, int lmax, int m, int d,
                   int ksub, int dsub, float* out, cudaStream_t stream) {
  const int mpad = (m + 15) / 16 * 16;
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(d) +
                      (RQ ? 0 : sizeof(int) * 2 * static_cast<size_t>(d)) +
                      static_cast<size_t>(kWarps) * mpad;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_pq_scan_kernel<RQ, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(nq) * nprobe);
  ivf_pq_scan_kernel<RQ, L2><<<blocks, kThreads, smem, stream>>>(
      lists, counts, probe_ids, xq, centroids, codebooks, mask, nprobe, nlist, lmax, m, d,
      ksub, dsub, mpad, out);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The caller sizes out
// as (nq, nprobe, lmax), keeps nq * nprobe below 2^31, and passes ksub a
// power of two <= 256 (dsub is unused for RQ).
extern "C" int dfx_ivf_pq_scan(const uint8_t* lists, const int* counts,
                               const int* probe_ids, const float* xq,
                               const float* centroids, const float* codebooks,
                               const int8_t* mask, int nq, int nprobe, int nlist, int lmax,
                               int m, int d, int ksub, int dsub, int rq, int l2, float* out,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (rq) {
    err = l2 ? launch<true, true>(lists, counts, probe_ids, xq, centroids, codebooks, mask,
                                  nq, nprobe, nlist, lmax, m, d, ksub, dsub, out, stream)
             : launch<true, false>(lists, counts, probe_ids, xq, centroids, codebooks, mask,
                                   nq, nprobe, nlist, lmax, m, d, ksub, dsub, out, stream);
  } else {
    err = l2 ? launch<false, true>(lists, counts, probe_ids, xq, centroids, codebooks, mask,
                                   nq, nprobe, nlist, lmax, m, d, ksub, dsub, out, stream)
             : launch<false, false>(lists, counts, probe_ids, xq, centroids, codebooks,
                                    mask, nq, nprobe, nlist, lmax, m, d, ksub, dsub, out,
                                    stream);
  }
  return static_cast<int>(err);
}
