// Pair-tile IVF,Flat scan, pipelined (K10), for Hopper (sm_90a).  Replaces
// the TPU kernel duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
// _pairs_flat_mega_kernel; the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_pairs_mega.py.
//
// Contract: K7's (ivf_pairs.cu): lists (nlist, lmax, d) fp32, counts
// (nlist,), xq_t (t_max, 8, d) the tiles' queries, qs (t_max, 8, 4) each
// slot's (bias, |q|^2, 0, 0) with bias -inf on empty slots, meta (1 +
// t_max,) = n_tiles and the tiles' list ids, optional mask (nlist, lmax)
// bytes; raw (t_max, 8, lmax) scores, IP x.q + bias, L2 -max(|q|^2 - 2 x.q
// + |x|^2, 0) + bias, -inf past the count or where the mask byte is 0;
// tiles t >= n_tiles (read on the device) left unwritten.  lmax must be a
// multiple of 4.  Each row's sums run over the dimensions in ascending
// order with fmaf, as in K7, so the tiles are bit-equal to K7's.
//
// Design.  The TPU kernel walked tps tiles a grid step with the next
// tiles' (lmax, d) fp32 blocks in flight.  One such block is lmax x 6 KB at
// d = 1536, so here the unit in flight is a chunk of 256 rows x 32 dims of
// one tile's list (37 KB with the tile's 8 query rows for those dims).
// * Persistent blocks that fetch their tiles from a device counter
//   (next_tile, zero before the launch), as K9: gridDim.x = the SMs times
//   the blocks an SM holds; a block that finds no tile issues no copy.
// * One item sequence (tile, row chunk, dim chunk) over the block's tiles,
//   rows below the count only; a ring of `stages` shared-memory stages
//   holds items in flight, item i + stages - 1 issued with cp.async
//   (cp_async.cuh) before item i computes, across tile boundaries; one
//   commit group an iteration; every issued copy is waited on, and the
//   block drains its groups before it exits.
// * The host takes the stage count (2 to 4) that keeps the most blocks on
//   an SM, the deepest ring among those: 2 stages and three blocks an SM
//   (75 KB each).  Measured on the H100 (IVF1024 x 1536, b1024): 64-dim
//   chunks in 3 stages (one block) took 2.40 ms, 32-dim chunks in 3
//   stages (two blocks) 2.00 ms, in 2 stages (three blocks) 1.64 ms, K7's
//   time.
// * A stage carries the chunk's rows (36 floats a row: 16-byte reads of 8
//   neighbouring rows hit 32 distinct banks), the 8 query rows' dims of
//   the chunk, and, with the last dim chunk, the row chunk's mask bytes.
//   Rows copy in 16-byte pieces when d % 4 == 0, else float by float; the
//   dims past d of the last chunk are zero-filled in rows and queries.
// * Compute is K7's: a thread owns a row, keeps the 8 dot products and the
//   row's squared norm in registers over the dim chunks, reads its row 4
//   dims at a time and each query's 4 dims as one 16-byte broadcast.
//   Whole row chunks past the count are written -inf without an item.
// * Offsets into the payload are 64-bit.
// What bounds it on the H100: fp32 FMAs (8 x lmax x d a tile) and the
// shared-memory reads feeding them, then each tile's list block, read
// once a tile.  Tensor cores (TF32 / 3xTF32), TMA with mbarriers and a
// producer warp are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kQG = 8;        // queries per tile
constexpr int kRows = 256;    // rows per chunk: one per thread
constexpr int kDK = 32;       // dims per chunk
constexpr int kXStride = 36;  // floats a staged row: 144 bytes, 36 words
constexpr int kStageBytes = 4 * kRows * kXStride + 4 * kQG * kDK + kRows;  // rows, queries, mask
constexpr int kMaxStages = 4;
static_assert(kStageBytes % 16 == 0, "stages stay 16-byte aligned");

struct Args {
  const float* lists;
  const int* counts;
  const float* xq_t;
  const float* qs;
  const int* meta;
  const uint8_t* mask;
  int t_max, nlist, lmax, d;
  int ncc;  // dim chunks a row
  int stages;
  int n_tiles;     // set on the device from meta[0]
  int* next_tile;  // the tile counter the blocks fetch from
};

// Position in a block's item sequence; every thread holds the same one.
struct Cursor {
  int tile, lid, cnt, nrc;
  int rc, cc;  // row chunk, dim chunk
  int seq;     // ordinal among the block's tiles with rows
  bool done;
};

// Shared-memory head: the tiles the block fetched, by seq % kRing, and a
// mailbox for the fetch (as in K9).
constexpr int kRing = kMaxStages + 1;
constexpr int kHeadBytes = 64;
static_assert(4 * (kRing + 1) <= kHeadBytes, "the head holds the ring");

__device__ __forceinline__ int tile_rows(const Args& a, int tile, int& lid) {
  lid = a.meta[1 + tile];
  const bool live = lid >= 0 && lid < a.nlist;
  return live ? min(max(a.counts[lid], 0), a.lmax) : 0;
}

// Rows of whole chunks at or past the count of a tile: -inf, no item.
__device__ __forceinline__ void clear_tail(const Args& a, int tile, int cnt, float* out) {
  const int from = (cnt + kRows - 1) / kRows * kRows;
  const int n = a.lmax - from;
  float* o = out + static_cast<int64_t>(tile) * kQG * a.lmax + from;
  for (int i = threadIdx.x; i < kQG * n; i += kRows) o[(i / n) * a.lmax + i % n] = -INFINITY;
}

// The fetching cursor's next tile with rows to score (tiles without rows
// are written -inf on the way), or done.  Every thread calls it.
__device__ __forceinline__ void fetch(Cursor& c, const Args& a, int* ring, float* out) {
  for (;;) {
    if (threadIdx.x == 0) ring[kRing] = atomicAdd(a.next_tile, 1);
    __syncthreads();
    const int tile = ring[kRing];
    __syncthreads();  // the mailbox is free again
    if (tile >= a.n_tiles) {
      c.done = true;
      return;
    }
    int lid;
    const int cnt = tile_rows(a, tile, lid);
    clear_tail(a, tile, cnt, out);
    if (cnt > 0) {
      c.tile = tile;
      c.lid = lid;
      c.cnt = cnt;
      c.nrc = (cnt + kRows - 1) / kRows;
      c.rc = c.cc = 0;
      ++c.seq;
      if (threadIdx.x == 0) ring[c.seq % kRing] = tile;
      return;
    }
  }
}

// The issuing cursor's next item, fetching a tile past the last one.
__device__ __forceinline__ void advance(Cursor& c, const Args& a, int* ring, float* out) {
  if (++c.cc < a.ncc) return;
  c.cc = 0;
  if (++c.rc < c.nrc) return;
  fetch(c, a, ring, out);
}

// The computing cursor's next item, through the tiles the issuing cursor
// fetched (it runs at least one item ahead).
__device__ __forceinline__ void follow(Cursor& c, const Args& a, const Cursor& lead,
                                       const int* ring) {
  if (++c.cc < a.ncc) return;
  c.cc = 0;
  if (++c.rc < c.nrc) return;
  if (c.seq == lead.seq) {
    c.done = true;
    return;
  }
  ++c.seq;
  c.tile = ring[c.seq % kRing];
  c.cnt = tile_rows(a, c.tile, c.lid);
  c.nrc = (c.cnt + kRows - 1) / kRows;
  c.rc = 0;
}

struct Stage {
  float* xs;  // [row][kXStride]
  float* q;   // [query][kDK]
  uint8_t* mask;
};

__device__ __forceinline__ Stage stage_at(uint8_t* base) {
  float* xs = reinterpret_cast<float*>(base);
  float* q = xs + kRows * kXStride;
  return {xs, q, reinterpret_cast<uint8_t*>(q + kQG * kDK)};
}

template <bool VEC4>
__device__ __forceinline__ void issue(const Cursor& c, const Args& a, Stage st) {
  const int r0 = c.rc * kRows, k0 = c.cc * kDK;
  const int64_t row0 = static_cast<int64_t>(c.lid) * a.lmax + r0;
  const int nrows = min(kRows, c.cnt - r0);
  const int nd = min(kDK, a.d - k0);
  const float* qt = a.xq_t + static_cast<int64_t>(c.tile) * kQG * a.d + k0;
  if (VEC4) {  // d % 4 == 0: nd is whole pieces
    const int per = nd / 4;
    for (int p = threadIdx.x; p < nrows * per; p += kRows) {
      const int rr = p / per, k = p - rr * per;
      cpa::copy16(st.xs + rr * kXStride + 4 * k, a.lists + (row0 + rr) * a.d + k0 + 4 * k);
    }
    for (int p = threadIdx.x; p < kQG * per; p += kRows) {
      const int q = p / per, k = p - q * per;
      cpa::copy16(st.q + q * kDK + 4 * k, qt + static_cast<int64_t>(q) * a.d + 4 * k);
    }
  } else {  // float by float, the dims up to a multiple of 4 zero-filled
    const int nd4 = (nd + 3) & ~3;
    for (int p = threadIdx.x; p < nrows * nd4; p += kRows) {
      const int rr = p / nd4, k = p - rr * nd4;
      const float* src = a.lists + (row0 + rr) * a.d + k0 + k;
      cpa::copy4(st.xs + rr * kXStride + k, k < nd ? src : a.lists, k < nd ? 4 : 0);
    }
    for (int p = threadIdx.x; p < kQG * nd4; p += kRows) {
      const int q = p / nd4, k = p - q * nd4;
      const float* src = qt + static_cast<int64_t>(q) * a.d + k;
      cpa::copy4(st.q + q * kDK + k, k < nd ? src : a.xq_t, k < nd ? 4 : 0);
    }
  }
  if (c.cc == a.ncc - 1 && a.mask != nullptr && 4 * static_cast<int>(threadIdx.x) < nrows)
    cpa::copy4(st.mask + 4 * threadIdx.x, a.mask + row0 + 4 * threadIdx.x);
}

template <bool L2>
__device__ __forceinline__ void compute(const Cursor& c, const Args& a, Stage st,
                                        float (&acc)[kQG], float& bn, const float (&bias)[kQG],
                                        const float (&qn)[kQG], float* __restrict__ out) {
  const int r0 = c.rc * kRows, k0 = c.cc * kDK;
  const int nrows = min(kRows, c.cnt - r0);
  const int t = threadIdx.x;
  if (t < nrows) {
    const int nd4 = (min(kDK, a.d - k0) + 3) & ~3;
    const float* xr = st.xs + t * kXStride;
    for (int c4 = 0; c4 < nd4; c4 += 4) {  // ascending dims, zero padding adds nothing
      const float4 x = *reinterpret_cast<const float4*>(xr + c4);
#pragma unroll
      for (int q = 0; q < kQG; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(st.q + q * kDK + c4);
        acc[q] = fmaf(x.x, v.x, acc[q]);
        acc[q] = fmaf(x.y, v.y, acc[q]);
        acc[q] = fmaf(x.z, v.z, acc[q]);
        acc[q] = fmaf(x.w, v.w, acc[q]);
      }
      bn = fmaf(x.x, x.x, bn);
      bn = fmaf(x.y, x.y, bn);
      bn = fmaf(x.z, x.z, bn);
      bn = fmaf(x.w, x.w, bn);
    }
  }
  if (c.cc != a.ncc - 1) return;
  const int r = r0 + t;
  if (r < a.lmax) {
    float* o = out + static_cast<int64_t>(c.tile) * kQG * a.lmax + r;
    const bool valid = t < nrows && (a.mask == nullptr || st.mask[t] != 0);
#pragma unroll
    for (int q = 0; q < kQG; ++q) {
      float s = -INFINITY;
      if (valid) s = L2 ? -fmaxf(qn[q] - 2.f * acc[q] + bn, 0.f) + bias[q] : acc[q] + bias[q];
      o[q * a.lmax] = s;
    }
  }
#pragma unroll
  for (int q = 0; q < kQG; ++q) acc[q] = 0.f;
  bn = 0.f;
}

template <bool VEC4, bool L2>
__global__ void __launch_bounds__(kRows) ivf_pairs_mega_kernel(Args a, float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* ring = reinterpret_cast<int*>(smem4);
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4) + kHeadBytes;
  a.n_tiles = min(a.meta[0], a.t_max);
  const int S = a.stages;
  Cursor is{0, 0, 0, 0, 0, 0, -1, false};
  fetch(is, a, ring, out);  // a block that finds no tile issues nothing
  Cursor cs = is;
  for (int j = 0; j < S - 1; ++j) {  // prologue: S - 1 items in flight
    if (!is.done) {
      issue<VEC4>(is, a, stage_at(smem + j * kStageBytes));
      advance(is, a, ring, out);
    }
    cpa::commit();
  }
  float acc[kQG], bias[kQG], qn[kQG], bn = 0.f;
#pragma unroll
  for (int q = 0; q < kQG; ++q) acc[q] = 0.f;
  for (int i = 0; !cs.done; ++i) {
    if (!is.done) {
      issue<VEC4>(is, a, stage_at(smem + ((i + S - 1) % S) * kStageBytes));
      advance(is, a, ring, out);
    }
    cpa::commit();
    cpa::wait_pending(S - 1);  // item i's group has landed
    __syncthreads();
    if (cs.rc == 0 && cs.cc == 0) {
#pragma unroll
      for (int q = 0; q < kQG; ++q) {
        bias[q] = a.qs[(static_cast<int64_t>(cs.tile) * kQG + q) * 4];
        qn[q] = a.qs[(static_cast<int64_t>(cs.tile) * kQG + q) * 4 + 1];
      }
    }
    compute<L2>(cs, a, stage_at(smem + (i % S) * kStageBytes), acc, bn, bias, qn, out);
    __syncthreads();  // stage i % S is free for item i + S
    follow(cs, a, is, ring);
  }
  cpa::wait_pending(0);
}

template <bool VEC4, bool L2>
cudaError_t launch(Args a, float* out, int* plan, cudaStream_t stream) {
  auto kernel = ivf_pairs_mega_kernel<VEC4, L2>;
  int dev, smem_max, nsm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int stages = 0, per_sm = 0;
  for (int st = 2; st <= kMaxStages && kHeadBytes + st * kStageBytes <= smem_max; ++st) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kHeadBytes + st * kStageBytes);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kRows,
                                                          kHeadBytes + st * kStageBytes);
    if (err != cudaSuccess) return err;
    if (blocks > 0 && blocks >= per_sm) {  // the most blocks an SM, then the deepest ring
      per_sm = blocks;
      stages = st;
    }
  }
  if (stages == 0) return cudaErrorInvalidValue;
  a.stages = stages;
  const size_t smem = kHeadBytes + stages * static_cast<size_t>(kStageBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = min(per_sm * nsm, a.t_max);
  if (plan != nullptr) {
    plan[0] = stages;
    plan[1] = grid;
  }
  kernel<<<grid, kRows, smem, stream>>>(a, out);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The caller sizes
// out as (t_max, 8, lmax) and passes t_max >= 1, lmax a multiple of 4, a
// 4-byte aligned mask, vec4 = 1 only with d % 4 == 0 and 16-byte aligned
// lists and xq_t, and next_tile one int set to 0.  plan (2 ints, or null)
// receives the stage count and the grid.
extern "C" int dfx_ivf_pairs_mega(const float* lists, const int* counts, const float* xq_t,
                                  const float* qs, const int* meta, const int8_t* mask, int t_max,
                                  int nlist, int lmax, int d, int l2, int vec4, int* next_tile,
                                  float* out, int* plan, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a{};
  a.lists = lists;
  a.counts = counts;
  a.xq_t = xq_t;
  a.qs = qs;
  a.meta = meta;
  a.mask = reinterpret_cast<const uint8_t*>(mask);
  a.t_max = t_max;
  a.nlist = nlist;
  a.lmax = lmax;
  a.d = d;
  a.ncc = (d + kDK - 1) / kDK;
  a.next_tile = next_tile;
  cudaError_t err;
  if (vec4)
    err = l2 ? launch<true, true>(a, out, plan, stream) : launch<true, false>(a, out, plan, stream);
  else
    err = l2 ? launch<false, true>(a, out, plan, stream)
             : launch<false, false>(a, out, plan, stream);
  return static_cast<int>(err);
}
