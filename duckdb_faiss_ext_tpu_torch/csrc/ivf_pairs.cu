// Pair-tile IVF,Flat search (K7), for Hopper (sm_90a).  Replaces the TPU
// kernel duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::_pairs_flat_kernel
// together with what its wrapper pallas_ivf_pairs_search ran around it
// (_pairs_flat_epilogue: the pair gather, top-k_scan, the fp32 rerank and
// the resolve); the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_pairs.py.
//
// Two designs, one source.
// * The fused search (dfx_ivf_pairs_topk, k_scan <= 1024): the contract,
//   the items and the 3xTF32 core are pairs_tf32.cuh's.  Two launches in
//   one C call: (a) the partial, one block an item (grid = the plan's
//   bound on the items; blocks past the item count, read on the device,
//   return at once), 8 warps that issue each chunk's copies into a 3-stage cp.async
//   ring (rows and queries at a padded stride of 36 floats, 16-byte copies
//   when d % 4 == 0 and lists and queries are 16-byte aligned, else 4-byte
//   ones; rows past the share and queries of dead slots zero-filled, never
//   read) and compute, as K1's partial does; (b) the merge, a warp a
//   query.  No score block is written.
// * The raw launch (dfx_ivf_pairs, the port's first design): for every tile t
//   < n_tiles with list l = meta[1 + t], query slot s and row r < lmax of
//   xq_t (t_max, 8, d), qs (t_max, 8, 4) = (bias, |q|^2, 0, 0) with bias
//   -inf on empty slots and meta (1 + t_max,) = n_tiles and the tiles'
//   list ids:
//     IP: x_r . q_s + bias_s      L2: -max(|q_s|^2 - 2 x_r . q_s + |x_r|^2, 0) + bias_s
//   and -inf where r >= counts[l] or mask[l, r] == 0; tiles t >= n_tiles
//   are left unwritten.  One block of 256 threads a tile streams the list
//   block through shared memory in chunks of 256 rows x 32 dims, each
//   thread owning one row and the 8 queries' fp32 FMA dot products.  The
//   search takes it with the plain epilogue above the fused search's
//   k_scan limit, and it is the design the fused search is timed against.
// Offsets into the payload are 64-bit.
//
// What bounds it on the H100: the distinct probed lists' rows, each read
// once (1.6 GB at IVF1024 262,144 x 1536, nprobe 16, b1024: 0.48 ms);
// 3xTF32 takes three tensor-core products a term (2 d a scored (query,
// row) pair, 0.1 ms there at the TF32 peak).  An item reads its share of
// a list once for up to 32 queries, so a list is read about once a batch;
// the raw launch read it once a tile and wrote, and its epilogue read
// back, a (t_max, 8, lmax) block (352 MB there).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "pairs_tf32.cuh"

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


// --- the fused search --------------------------------------------------------

constexpr int kMaxStages = 4;

// Floats of a ring stage: kNT rows, then QT query rows, kLD apart.
__host__ __device__ constexpr int stage_floats(int qt) { return (ptf::kNT + qt) * ptf::kLD; }

template <int T>
size_t partial_smem(int stages, int slots) {
  return 4 * static_cast<size_t>(stages) * stage_floats(ptf::kQG * T) +
         ptf::lists_bytes(ptf::kQG * T, slots);
}

template <int T, bool VEC4>
__global__ void __launch_bounds__(ptf::kThreads, 2)
pairs_topk_partial(const __grid_constant__ ptf::Args a) {
  constexpr int QT = ptf::kQG * T;
  constexpr int kStage = stage_floats(QT);
  constexpr int kNT = ptf::kNT, kDK = ptf::kDK, kLD = ptf::kLD;
  if (static_cast<int>(blockIdx.x) >= ptf::n_items(a)) return;  // block-uniform
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.p.stages, d = a.p.d;
  float* ring = reinterpret_cast<float*>(smem);
  ptf::Core<T, false, ptf::BlockSync> core(a, smem + 4 * static_cast<size_t>(S) * kStage,
                                           threadIdx.x);
  const ptf::Item it = ptf::item_at(a, blockIdx.x);
  core.begin(it);

  const int tid = threadIdx.x;
  const int nc = (d + kDK - 1) / kDK;
  const int total = it.nrt * nc;
  const float* rows = a.lists + (static_cast<int64_t>(it.lid) * a.p.lmax + it.r0) * d;
  // Into stage `stage`: dims [c0, c0 + kDK) of row tile rt's rows and of
  // the item's queries.
  auto load = [&](int stage, int rt, int c0) {
    float* st = ring + stage * kStage;
    const int nrows = min(kNT, it.r1 - it.r0 - rt * kNT);
    const float* src_rows = rows + static_cast<int64_t>(rt) * kNT * d + c0;
    if (VEC4) {
      for (int i = tid; i < (kNT + QT) * (kDK / 4); i += ptf::kThreads) {
        const int r = i / (kDK / 4), c4 = (i % (kDK / 4)) * 4;
        const float* src = a.lists;
        int bytes = 0;
        if (r < kNT) {
          if (r < nrows && c0 + c4 < d) {
            src = src_rows + static_cast<int64_t>(r) * d + c4;
            bytes = 16;
          }
        } else {
          const int q = core.qid[r - kNT];
          if (q >= 0 && c0 + c4 < d) {
            src = a.xq + static_cast<int64_t>(q) * d + c0 + c4;
            bytes = 16;
          }
        }
        cpa::copy16(st + r * kLD + c4, src, bytes);
      }
    } else {
      for (int i = tid; i < (kNT + QT) * kDK; i += ptf::kThreads) {
        const int r = i / kDK, c = i % kDK;
        const float* src = a.lists;
        int bytes = 0;
        if (r < kNT) {
          if (r < nrows && c0 + c < d) {
            src = src_rows + static_cast<int64_t>(r) * d + c;
            bytes = 4;
          }
        } else {
          const int q = core.qid[r - kNT];
          if (q >= 0 && c0 + c < d) {
            src = a.xq + static_cast<int64_t>(q) * d + c0 + c;
            bytes = 4;
          }
        }
        cpa::copy4(st + r * kLD + c, src, bytes);
      }
    }
  };
  // The copy position runs S - 1 chunks ahead of the compute one.
  int ld_it = 0, ld_rt = 0, ld_c = 0, ld_stage = 0;
  auto load_next = [&]() {
    if (ld_it < total) load(ld_stage, ld_rt, ld_c * kDK);
    cpa::commit();
    ++ld_it;
    if (++ld_c == nc) {
      ld_c = 0;
      ++ld_rt;
    }
    if (++ld_stage == S) ld_stage = 0;
  };
  for (int s = 0; s < S - 1; ++s) load_next();

  int rt = 0, c = 0, stage = 0;
  for (int i = 0; i < total; ++i) {
    cpa::wait_pending(S - 2);
    __syncthreads();
    load_next();
    if (c == 0) core.tile_begin(it, rt);
    const float* st = ring + stage * kStage;
    core.chunk(st, st + kNT * kLD, it.ntiles, rt == 0);
    if (++stage == S) stage = 0;
    if (++c < nc) continue;
    c = 0;
    core.tile_end(it, rt);
    ++rt;
  }
  cpa::wait_pending(0);
  core.end(it);
  core.flush_bn();
}

__global__ void __launch_bounds__(256) pairs_topk_merge(const __grid_constant__ ptf::MergeArgs a) {
  ptf::merge(a);
}

template <int T, bool VEC4>
cudaError_t launch_partial(const ptf::Args& a, cudaStream_t stream) {
  auto kernel = pairs_topk_partial<T, VEC4>;
  if (static_cast<size_t>(a.p.smem) < partial_smem<T>(a.p.stages, a.p.slots))
    return cudaErrorInvalidValue;
  cudaError_t err = ltk::set_smem(reinterpret_cast<const void*>(kernel), a.p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.p.items, ptf::kThreads, a.p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_partial_vec(const ptf::Args& a, cudaStream_t stream) {
  return a.p.vec4 ? launch_partial<T, true>(a, stream) : launch_partial<T, false>(a, stream);
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

// Returns the CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for a plan the kernels do not take.  plan holds
// ptf::Plan (ops/ivf_pairs.py::plan); order / ends / item_list / head the
// item tables (ops/ivf_pairs.py::pair_items, head zeroed); part_s /
// part_p (nq * nprobe * shares, k2); out_s / out_p (nq, k); unproven an
// int the caller reads or zeroes.  stages: bit 0 the partial, bit 1 the
// merge.  vec4 = 1 only with d % 4 == 0 and 16-byte aligned lists and xq.
extern "C" int dfx_ivf_pairs_topk(const float* lists, const int* counts, const int* row_pos,
                                  const int* probe_ids, const float* xq, const int8_t* mask,
                                  const int64_t* order, const int* ends, const int* item_list,
                                  int* head, const int* plan, float* part_s, int* part_p,
                                  float* out_s, int* out_p, int* unproven, int stages,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ptf::Plan p = ptf::plan_from(plan);
  if (p.stages < 2 || p.stages > kMaxStages || p.k < 1 || p.k > p.k2 ||
      p.slots < p.k2 + 64 || p.share_rows % ptf::kNT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if ((stages & 1) && p.items > 0) {
    const ptf::Args a{lists, counts, mask, xq, order, ends, item_list, head, part_s, part_p, p};
    switch (p.tiles) {
      case 1: err = launch_partial_vec<1>(a, stream); break;
      case 2: err = launch_partial_vec<2>(a, stream); break;
      case 4: err = launch_partial_vec<4>(a, stream); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    const ptf::MergeArgs m{lists, counts, row_pos, probe_ids, xq, head, part_s, part_p,
                           out_s, out_p, unproven, p};
    err = ltk::set_smem(reinterpret_cast<const void*>(pairs_topk_merge), p.merge_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (p.nq + p.merge_warps - 1) / p.merge_warps;
    pairs_topk_merge<<<blocks, 32 * p.merge_warps, p.merge_smem, stream>>>(m);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
