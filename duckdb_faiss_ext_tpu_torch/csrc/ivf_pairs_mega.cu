// Pair-tile IVF,Flat search, pipelined (K10), for Hopper (sm_90a).
// Replaces the TPU kernel duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
// _pairs_flat_mega_kernel with its epilogue (pallas_ivf_pairs_search(...,
// mega=True)); the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_pairs_mega.py.
//
// Two designs, one source.
// * The fused search (dfx_ivf_pairs_mega_topk): K7's function on K7's
//   items with pairs_tf32.cuh's core, so its candidates and results are
//   bit-equal to K7's (ivf_pairs.cu); what differs is how the chunks move.
//   The TPU kernel walked tps tiles a grid step with the next tiles' list
//   blocks in flight; here persistent blocks (the SMs times the blocks an
//   SM holds: two where the plan's ring leaves room, as at k_scan 42 with
//   3 stages, so that one block's top-k epilogue runs beside the other's
//   copies and products) take items from the device counter in the item
//   tables' head, and one producer warp keeps a ring of stages full while
//   8 consumer warps compute (a named barrier among them; the producer
//   never joins it).  For each (row tile, dim chunk) of its items the
//   producer waits for the stage's `empty` mbarrier, writes the chunk's
//   header into the stage, copies the item's query rows' 32 dims with
//   cp.async (a lane a query row; dead slots zero-filled) and has the
//   Tensor Memory Accelerator copy the rows below the share's end as
//   boxes of 32 rows x 32 dims of the lists viewed as (nlist * lmax, d)
//   fp32 (dims past d zero-filled, 128-byte swizzled), all completing on
//   the stage's `full` mbarrier (32 arrivals: each lane's cp.async
//   tracked by cp.async.mbarrier.arrive, lane 0's with the boxes' bytes).
//   Each consumer warp waits on `full`, runs the chunk and arrives on
//   `empty`; a row tile's epilogue and an item's end follow as in K7.  A
//   stage is read by every consumer warp in order, so a barrier's phases
//   cannot alias.  The tensor map is encoded at each launch
//   (tma_2d.cuh).  Widths TMA does not take (d % 4 != 0, or lists or
//   queries not 16-byte aligned) run the cp.async instance: the producer
//   warp copies rows and queries 4 bytes at a time at K7's padded stride.
// * The raw launch (dfx_ivf_pairs_mega, the first pipelined design): K7's raw
//   tiles, bit-equal, through persistent blocks and a cp.async ring of
//   256-row x 32-dim chunks; the search takes it with the plain epilogue
//   above the fused search's k_scan limit.
// Offsets into the payload are 64-bit.
//
// What bounds it on the H100: K7's (the distinct probed rows, each read
// once); the producer warp spends no thread of the consumers on copies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "list_topk.cuh"
#include "pairs_tf32.cuh"
#include "tma_2d.cuh"

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


// --- the fused search --------------------------------------------------------

constexpr int kBoxRows = 32;                          // TMA boxes: 32 rows x 32 dims
constexpr int kBoxBytes = kBoxRows * ptf::kDK * 4;
constexpr int kMaxRing = 8;
constexpr int kMegaThreads = 32 + ptf::kThreads;      // a producer warp, 8 consumers

// A stage's chunk, written by the producer before it arrives on `full`.
struct Chunk {
  int item;  // < 0: no more items
  int rt, cc, pad;
};

// Bytes of a stage's rows (TMA: dense swizzled 128-byte rows) and of a
// stage (TMA: 1024-byte aligned for the swizzle).
__host__ __device__ constexpr int rows_bytes(bool tma) {
  return tma ? ptf::kNT * ptf::kDK * 4 : ptf::kNT * ptf::kLD * 4;
}

__host__ __device__ constexpr int mega_stage_bytes(int qt, bool tma) {
  return tma ? (rows_bytes(true) + qt * ptf::kLD * 4 + 1023) / 1024 * 1024
             : rows_bytes(false) + qt * ptf::kLD * 4;
}

__host__ __device__ constexpr size_t mega_smem(int qt, bool tma, int stages, int slots) {
  return 1024 + static_cast<size_t>(stages) * (mega_stage_bytes(qt, tma) + sizeof(Chunk) + 16) +
         ptf::lists_bytes(qt, slots);
}

// The producer warp (all 32 lanes): every chunk of the items it takes,
// then one end chunk.
template <int T, bool TMA>
__device__ inline void produce(const CUtensorMap* map, const ptf::Args& a, uint8_t* stages,
                               Chunk* hdr, uint64_t* full, uint64_t* empty, int lane) {
  constexpr int QT = ptf::kQG * T, kDK = ptf::kDK, kLD = ptf::kLD, kNT = ptf::kNT;
  constexpr int stage_bytes = mega_stage_bytes(QT, TMA);
  const int S = a.p.stages, d = a.p.d, lmax = a.p.lmax;
  const int nc = (d + kDK - 1) / kDK;
  const int n = ptf::n_items(a);
  for (int i = 0;;) {
    int idx = 0;
    if (lane == 0) idx = atomicAdd(a.head, 1);
    idx = __shfl_sync(ltk::kFull, idx, 0);
    if (idx >= n) {
      // Each block's producer takes one index past the items; the last of
      // them zeroes the counter for the next launch on the same tables.
      if (lane == 0 && idx == n + static_cast<int>(gridDim.x) - 1) atomicExch(a.head, 0);
      const int s = i % S;
      ltk::bar_wait(&empty[s], ((i / S) & 1) ^ 1);
      if (lane == 0) hdr[s] = Chunk{-1, 0, 0, 0};
      ltk::bar_arrive(&full[s]);
      return;
    }
    const ptf::Item it = ptf::item_at(a, idx);
    int q = -1;  // this lane's query row
    if (lane < it.npairs) q = static_cast<int>(a.order[it.first + lane] / a.p.nprobe);
    const float* qsrc = a.xq + static_cast<int64_t>(q < 0 ? 0 : q) * d;
    for (int rt = 0; rt < it.nrt; ++rt) {
      const int row0 = it.r0 + rt * kNT;
      const int nrows = min(kNT, it.r1 - row0);
      for (int cc = 0; cc < nc; ++cc, ++i) {
        const int s = i % S;
        ltk::bar_wait(&empty[s], ((i / S) & 1) ^ 1);
        uint8_t* st = stages + static_cast<size_t>(s) * stage_bytes;
        float* qdst = reinterpret_cast<float*>(st + rows_bytes(TMA)) + lane * kLD;
        if (lane == 0) hdr[s] = Chunk{idx, rt, cc, 0};
        const int c0 = cc * kDK;
        if (lane < QT) {
          if (TMA) {
#pragma unroll
            for (int e = 0; e < kDK; e += 4) {
              const bool ok = q >= 0 && c0 + e < d;
              cpa::copy16(qdst + e, ok ? qsrc + c0 + e : a.xq, ok ? 16 : 0);
            }
          } else {
            for (int e = 0; e < kDK; ++e) {
              const bool ok = q >= 0 && c0 + e < d;
              cpa::copy4(qdst + e, ok ? qsrc + c0 + e : a.xq, ok ? 4 : 0);
            }
          }
        }
        if (!TMA) {
          float* dr = reinterpret_cast<float*>(st);
          const float* src = a.lists + (static_cast<int64_t>(it.lid) * lmax + row0) * d + c0;
          for (int e = lane; e < nrows * kDK; e += 32) {
            const int r = e / kDK, c = e % kDK;
            const bool ok = c0 + c < d;
            cpa::copy4(dr + r * kLD + c, ok ? src + static_cast<int64_t>(r) * d + c : a.lists,
                       ok ? 4 : 0);
          }
        }
        ltk::copies_arrive(&full[s]);
        if (TMA && lane == 0) {
          const int boxes = (nrows + kBoxRows - 1) / kBoxRows;
          ltk::bar_expect(&full[s], boxes * kBoxBytes);
          for (int b = 0; b < boxes; ++b)
            tma2d::box(st + b * kBoxBytes, map, c0, it.lid * lmax + row0 + b * kBoxRows,
                       &full[s]);
        } else {
          ltk::bar_arrive(&full[s]);
        }
      }
    }
  }
}

template <int T, bool TMA, int MINB>
__global__ void __launch_bounds__(kMegaThreads, MINB)
pairs_mega_partial(const __grid_constant__ CUtensorMap map, const __grid_constant__ ptf::Args a) {
  constexpr int QT = ptf::kQG * T;
  constexpr int stage_bytes = mega_stage_bytes(QT, TMA);
  extern __shared__ int4 smem4[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  const int S = a.p.stages;
  uint8_t* lists_smem = stages + static_cast<size_t>(S) * stage_bytes;
  Chunk* hdr = reinterpret_cast<Chunk*>(lists_smem + ptf::lists_bytes(QT, a.p.slots));
  uint64_t* full = reinterpret_cast<uint64_t*>(hdr + S);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      ltk::bar_init(&full[s], 32);
      ltk::bar_init(&empty[s], ptf::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    produce<T, TMA>(&map, a, stages, hdr, full, empty, lane);
    return;
  }
  ptf::Core<T, TMA, ptf::ConsumerSync> core(a, lists_smem, threadIdx.x - 32);
  const int nc = (a.p.d + ptf::kDK - 1) / ptf::kDK;
  ptf::Item it{};
  for (int i = 0;; ++i) {
    const int s = i % S;
    ltk::bar_wait(&full[s], (i / S) & 1);
    const Chunk ch = hdr[s];
    if (ch.item < 0) break;  // block-uniform
    if (ch.rt == 0 && ch.cc == 0) {
      it = ptf::item_at(a, ch.item);
      core.begin(it);
    }
    if (ch.cc == 0) core.tile_begin(it, ch.rt);
    const uint8_t* st = stages + static_cast<size_t>(s) * stage_bytes;
    core.chunk(reinterpret_cast<const float*>(st),
               reinterpret_cast<const float*>(st + rows_bytes(TMA)), it.ntiles, ch.rt == 0);
    __syncwarp();
    if (lane == 0) ltk::bar_arrive(&empty[s]);
    if (ch.cc == nc - 1) {
      core.tile_end(it, ch.rt);
      if (ch.rt == it.nrt - 1) core.end(it);
    }
  }
  core.flush_bn();
}

__global__ void __launch_bounds__(256) pairs_mega_merge(const __grid_constant__ ptf::MergeArgs a) {
  ptf::merge(a);
}

// The lists as (nlist * lmax, d) fp32, boxes of 32 dims x 32 rows,
// 128-byte swizzled, zeros past d.
bool encode_lists(CUtensorMap* map, const ptf::Args& a) {
  tma2d::EncodeTiled encode = tma2d::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t size[2] = {static_cast<cuuint64_t>(a.p.d),
                              static_cast<cuuint64_t>(a.p.nlist) * a.p.lmax};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(a.p.d) * 4};
  const cuuint32_t box[2] = {ptf::kDK, kBoxRows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.lists), size,
                stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int T, bool TMA, int MINB>
cudaError_t launch_mega(const ptf::Args& a, int* grid, cudaStream_t stream) {
  if (a.p.stages > kMaxRing ||
      static_cast<size_t>(a.p.smem) < mega_smem(ptf::kQG * T, TMA, a.p.stages, a.p.slots))
    return cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (TMA && !encode_lists(&map, a)) return cudaErrorInvalidValue;
  auto kernel = pairs_mega_partial<T, TMA, MINB>;
  int dev, nsm, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kMegaThreads, a.p.smem);
  if (err != cudaSuccess) return err;
  if (blocks == 0) return cudaErrorInvalidValue;
  *grid = min(blocks * nsm, a.p.items);
  kernel<<<*grid, kMegaThreads, a.p.smem, stream>>>(map, a);
  return cudaGetLastError();
}

// Two blocks an SM where two fit the SM's 228 KB (1 KB each reserved).
template <int T>
cudaError_t launch_mega_copy(const ptf::Args& a, int* grid, cudaStream_t stream) {
  if (2 * (a.p.smem + 1024) <= 228 * 1024)
    return a.p.tma ? launch_mega<T, true, 2>(a, grid, stream)
                   : launch_mega<T, false, 2>(a, grid, stream);
  return a.p.tma ? launch_mega<T, true, 1>(a, grid, stream)
                 : launch_mega<T, false, 1>(a, grid, stream);
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

// Returns the CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for a plan the kernels do not take or a tensor map
// cuTensorMapEncodeTiled refuses.  The arguments are dfx_ivf_pairs_topk's (K7), head
// holding the zeroed item counter; tma = 1 in the plan only with d % 4 ==
// 0 and 16-byte aligned lists and xq.  grid (or null) receives the
// partial's blocks.
extern "C" int dfx_ivf_pairs_mega_topk(const float* lists, const int* counts, const int* row_pos,
                                       const int* probe_ids, const float* xq, const int8_t* mask,
                                       const int64_t* order, const int* ends, const int* item_list,
                                       int* head, const int* plan, float* part_s, int* part_p,
                                       float* out_s, int* out_p, int* unproven, int* grid,
                                       int stages, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ptf::Plan p = ptf::plan_from(plan);
  if (p.stages < 2 || p.k < 1 || p.k > p.k2 || p.slots < p.k2 + 64 ||
      p.share_rows % ptf::kNT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  int blocks = 0;
  if ((stages & 1) && p.items > 0) {
    const ptf::Args a{lists, counts, mask, xq, order, ends, item_list, head, part_s, part_p, p};
    switch (p.tiles) {
      case 1: err = launch_mega_copy<1>(a, &blocks, stream); break;
      case 2: err = launch_mega_copy<2>(a, &blocks, stream); break;
      case 4: err = launch_mega_copy<4>(a, &blocks, stream); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (grid != nullptr) *grid = blocks;
  if (stages & 2) {
    const ptf::MergeArgs m{lists, counts, row_pos, probe_ids, xq, head, part_s, part_p,
                           out_s, out_p, unproven, p};
    err = ltk::set_smem(reinterpret_cast<const void*>(pairs_mega_merge), p.merge_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int mblocks = (p.nq + p.merge_warps - 1) / p.merge_warps;
    pairs_mega_merge<<<mblocks, 32 * p.merge_warps, p.merge_smem, stream>>>(m);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
