// Per-query IVF,Flat list search (K6), for Hopper (sm_90a).  Replaces the
// TPU kernel duckdb_faiss_ext_tpu/ops/pallas_ivf.py::_scan_kernel and what
// its caller pallas_ivf_search ran around it (exact_topk and the resolve
// through row_pos); the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_list_scan.py.
//
// Contract: lists (nlist, lmax, d) fp32 padded per list, counts (nlist,),
// row_pos (nlist, lmax), probe_ids (nq, nprobe), xq (nq, d), optional mask
// (nlist, lmax) bytes.  A live slot r < counts[l] (mask byte not 0) of a
// probed list l scores
//   IP: x_r . q        L2: -sum_d (x_r - q)^2   (difference form, as the
//   TPU kernel computes it: the expansion form cancels differently and
//   would move near-ties).
//
// Two designs, one source.
// * The fused search (dfx_ivf_list_topk, k <= 1024): for each query the k
//   best (score, storage row), sorted by score descending, then by flat
//   index (probe slot * lmax + slot) ascending; missing slots (-inf, -1).
//   The skeleton is list_topk.cuh: (a) a partial launch over queries x
//   splits (equal shares of a query's row chunks) streams each probed
//   list's live rows through a ring of shared-memory stages (TMA bulk
//   copies fed by a producer warp), four consumer warps score them and
//   keep their best k, merged into a block's list of k; (b) a merge launch, a warp a query, merges the splits'
//   lists and resolves positions.  No score block is written.  The row
//   score (FlatScore): `lanes` lanes a row along d (a power of two up to
//   the row's units, a unit being 4 floats when d % 4 == 0, else 1: at
//   most 8 for rows of up to 1 KB, whose chunks hold a dozen rows or more,
//   and 32 for wider ones, whose chunks hold a row or two), so d = 8 puts
//   16 rows on a warp and d = 128 four; a lane sums its units in order
//   (the first four from registers, the rest of the query from shared
//   memory) with fp32 FMAs, and list_topk.cuh::reduce_scatter gathers 32
//   rows' partials so that each lane ends with one row.  Every row's score
//   is one fixed tree of the same sums, so the partial's scores are the
//   results (no rescore).
// * The raw launch (dfx_ivf_list_scan): out[i, j, r] for every slot r <
//   lmax of every (query i, probe slot j), -inf where r >= counts[l] or
//   mask[l, r] == 0; one block of 256 threads a (query, probed list) pair,
//   a warp a row, 16-byte loads along d and a shuffle reduction.  The
//   search takes it with torch's exact_topk above the fused search's k
//   limit (a shape rule, as K8's gather path), and it is the in-tree
//   "before" the fused search is timed against.
// Offsets into the payload are 64-bit: lid * lmax * d passes 2^31 at
// realistic sizes (4096 lists x lmax 1024 x d 1536).
//
// What bounds it on the H100: the bytes of the probed lists, each read once
// (at IVF4096 1M x 128, nprobe 64, b1024: ~512 MB, 0.15 ms at 3.35 TB/s).
// A per-query scan reads a list once for each query that probes it (8 GB
// there, mostly from L2), so L2's rate, not device memory's, sets its
// floor; sharing lists across queries is the pair tiles' form (K7).  The
// raw launch also writes the (nq, nprobe, lmax) score block (403 MB at
// b1024, lmax 1536), which its top-k reads back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "list_topk.cuh"

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

// --- the fused search ----------------------------------------------------------

namespace {

// fp32 partial of one unit (in dimension order) onto acc.
template <bool L2>
__device__ __forceinline__ float step(float a, float b, float acc) {
  if (L2) {
    const float t = a - b;
    return fmaf(t, t, acc);
  }
  return fmaf(a, b, acc);
}

template <bool L2>
__device__ __forceinline__ float step(float4 a, float4 b, float acc) {
  acc = step<L2>(a.x, b.x, acc);
  acc = step<L2>(a.y, b.y, acc);
  acc = step<L2>(a.z, b.z, acc);
  return step<L2>(a.w, b.w, acc);
}

template <bool VEC4>
struct Unit {
  using T = float;
};
template <>
struct Unit<true> {
  using T = float4;
};

// The row score of the fused search: L lanes a row, units along d.
template <bool VEC4, bool L2, int L>
struct FlatScore {
  using V = typename Unit<VEC4>::T;
  static constexpr int R = 32 / L;  // rows a pass
  static constexpr int JR = 4;      // the query's units a lane keeps in registers
  const V* q;                       // the query in shared memory
  int units, row_bytes;
  V qr[JR];

  __device__ FlatScore(const float* q_s, int d, int lane)
      : q(reinterpret_cast<const V*>(q_s)),
        units(VEC4 ? d / 4 : d),
        row_bytes(4 * d) {
#pragma unroll
    for (int i = 0; i < JR; ++i) {
      const int u = lane % L + i * L;
      qr[i] = u < units ? q[u] : V();
    }
  }

  __device__ float score_chunk(const uint8_t* st, int n, int64_t, int lane, int& row) const {
    const int t = lane % L, g = lane / L;
    float acc[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      acc[j] = 0.f;
      const int r = j * R + g;
      if (r < n) {
        const V* x = reinterpret_cast<const V*>(st + r * row_bytes);
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < JR; ++i) {
          const int u = t + i * L;
          if (u < units) a = step<L2>(x[u], qr[i], a);
        }
        for (int u = t + JR * L; u < units; u += L) a = step<L2>(x[u], q[u], a);
        acc[j] = a;
      }
    }
    ltk::reduce_scatter<L>(acc, lane);
    row = ltk::scattered_row<L>(lane);
    return L2 ? -acc[0] : acc[0];
  }
};

constexpr int kMaxWarps = 8;  // consumer warps a partial block at most

template <bool VEC4, bool L2, int L>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1))
ivf_list_topk_partial(const ltk::Plan p, const float* __restrict__ lists,
                      const int* __restrict__ counts, const int* __restrict__ probe_ids,
                      const float* __restrict__ xq, const int8_t* __restrict__ mask, int d,
                      float* __restrict__ part_s, int* __restrict__ part_p) {
  extern __shared__ __align__(128) unsigned char smem_topk[];
  float* q_s = reinterpret_cast<float*>(smem_topk + ((ltk::partial_head_bytes(p) + 15) & ~15));
  const int64_t q = blockIdx.x;
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_s[i] = xq[q * d + i];
  __syncthreads();
  const FlatScore<VEC4, L2, L> score(q_s, d, threadIdx.x & 31);
  ltk::partial(score, smem_topk, p, reinterpret_cast<const uint8_t*>(lists), counts, probe_ids,
               mask, part_s, part_p);
}

// A warp a query: its splits' lists merged, the best k resolved.
__global__ void __launch_bounds__(32)
ivf_list_topk_merge(const ltk::Plan p, const int* __restrict__ row_pos,
                    const int* __restrict__ probe_ids, const float* __restrict__ part_s,
                    const int* __restrict__ part_p, float* __restrict__ out_s,
                    int* __restrict__ out_p) {
  extern __shared__ __align__(16) unsigned char smem_merge[];
  float* s = reinterpret_cast<float*>(smem_merge);
  int* pos = reinterpret_cast<int*>(s + p.merge_slots);
  const int q = blockIdx.x, lane = threadIdx.x & 31;
  ltk::TopK top;
  ltk::merge_splits(top, s, pos, p, part_s, part_p, q, lane);
  for (int t = lane; t < p.k; t += 32) {
    const float sc = t < p.k2 ? s[t] : -INFINITY;
    const int row = sc == -INFINITY ? -1 : ltk::resolve(pos[t], p, probe_ids, row_pos, q);
    out_s[static_cast<int64_t>(q) * p.k + t] = row < 0 ? -INFINITY : sc;
    out_p[static_cast<int64_t>(q) * p.k + t] = row;
  }
}

template <bool VEC4, bool L2, int L>
cudaError_t launch_partial(const ltk::Plan& p, const float* lists, const int* counts,
                           const int* probe_ids, const float* xq, const int8_t* mask, int d,
                           float* part_s, int* part_p, cudaStream_t stream) {
  const auto kernel = ivf_list_topk_partial<VEC4, L2, L>;
  const cudaError_t err = ltk::set_smem(reinterpret_cast<const void*>(kernel), p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nq, p.splits), 32 * (p.warps + 1), p.smem, stream>>>(
      p, lists, counts, probe_ids, xq, mask, d, part_s, part_p);
  return cudaGetLastError();
}

template <bool VEC4, bool L2>
cudaError_t launch_partial_lanes(int lanes, const ltk::Plan& p, const float* lists,
                                 const int* counts, const int* probe_ids, const float* xq,
                                 const int8_t* mask, int d, float* part_s, int* part_p,
                                 cudaStream_t stream) {
#define DFX_PARTIAL(L) \
  launch_partial<VEC4, L2, L>(p, lists, counts, probe_ids, xq, mask, d, part_s, part_p, stream)
  switch (lanes) {
    case 1: return DFX_PARTIAL(1);
    case 2: return DFX_PARTIAL(2);
    case 4: return DFX_PARTIAL(4);
    case 8: return DFX_PARTIAL(8);
    case 16: return DFX_PARTIAL(16);
    case 32: return DFX_PARTIAL(32);
    default: return cudaErrorInvalidValue;
  }
#undef DFX_PARTIAL
}

}  // namespace

// The fused search: runs the launches named by `stages` (1 the partial, 2
// the merge) on `stream`; returns the CUDA error of the first that fails (0
// on success), cudaErrorInvalidValue for a shape it does not take.  plan:
// ltk::kPlanInts ints (ops/ivf_list_scan.py::plan): k2 == k <= 1024,
// warps <= 8, the smem sizes cover list_topk.cuh's layout plus the query
// (partial) and merge_slots (score, position) pairs (merge); lanes a power
// of two up to 32 (ops/ivf_list_scan.py::_shape); vec4 = 1 only with d % 4 == 0 and
// 16-byte aligned lists and xq; tma = 1 only with lists' first and last
// byte on 16-byte boundaries.  part_s / part_p (nq, splits, k), out_s /
// out_p (nq, k).
extern "C" int dfx_ivf_list_topk(const float* lists, const int* counts, const int* row_pos,
                                 const int* probe_ids, const float* xq, const int8_t* mask,
                                 const int* plan, int d, int l2, int vec4, int lanes,
                                 float* part_s, int* part_p, float* out_s, int* out_p,
                                 int stages, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ltk::Plan p = ltk::plan_from(plan);
  if (p.warps < 1 || p.warps > kMaxWarps || p.stages % p.warps != 0 || p.stages < p.warps || p.k2 != p.k ||
      p.chunk_rows < 1 || p.chunk_rows > ltk::kChunkRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
#define DFX_LANES(V, L2) \
  launch_partial_lanes<V, L2>(lanes, p, lists, counts, probe_ids, xq, mask, d, part_s, part_p, stream)
    if (vec4)
      err = l2 ? DFX_LANES(true, true) : DFX_LANES(true, false);
    else
      err = l2 ? DFX_LANES(false, true) : DFX_LANES(false, false);
#undef DFX_LANES
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    err = ltk::set_smem(reinterpret_cast<const void*>(ivf_list_topk_merge), p.merge_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ivf_list_topk_merge<<<p.nq, 32, p.merge_smem, stream>>>(p, row_pos, probe_ids, part_s,
                                                             part_p, out_s, out_p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
