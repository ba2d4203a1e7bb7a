// Pair-tile IVF,SQ8/SQ4/SQ6 int8 scan, pipelined (K9), for Hopper
// (sm_90a).  Replaces the TPU kernel duckdb_faiss_ext_tpu/ops/
// pallas_ivf_pairs.py::_pairs_sq_mega_kernel; the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_sq_pairs_mega.py.
//
// Contract: K3's (ivf_sq_pairs.cu), so its raw (t_max, 8, lmax) tiles are
// bit-equal to K3's: codes (nlist, lmax, w) uint8, rn / rs (nlist, lmax)
// fp32, counts (nlist,), digits (t_max * 8, 2, width) int8, qs (t_max, 8,
// 4) fp32 (su2, c0, base, mu; base +inf (L2) / -inf (IP) on empty slots),
// meta (1 + t_max,) = n_tiles and the tiles' list ids, optional mask
// (nlist, lmax) bytes.  Tiles t >= n_tiles (read on the device) are left
// unwritten.  lmax must be a multiple of 4, codes 16-byte aligned and rn
// / rs 8-byte aligned (a lane loads two rows' scalars as one float2).
//
// Design.  The TPU kernel walked tps tiles a grid step and kept the copies
// of the next slots - 1 tiles' list blocks in flight while one tile
// computed.  A list block here (2560 x 1536 B = 3.9 MB at the MS MARCO
// shape) is far beyond the 227 KB a block may hold, so the unit in flight
// is a chunk: 256 rows x 128 code bytes of one tile's list, with the
// digits of its 128 dimensions (256 for sq4).
// * Persistent blocks, one an SM, take the next tile from a device counter
//   (next_tile, zero before the launch) until none below n_tiles is left,
//   so blocks given long lists take fewer tiles, and walk one sequence of
//   items (tile, row chunk, column chunk) over their tiles, rows below the
//   tile's count only; the next tile's first chunks stream in while the
//   current tile's last ones compute.
// * A producer warp keeps a ring of 2-6 stages full (TMA): one lane takes
//   the tiles, waits for a stage's `empty` mbarrier, writes the item into
//   the stage's header, and has the Tensor Memory Accelerator copy the
//   chunk's rows below the count as boxes of 64 rows x 128 bytes of the
//   payload viewed as (nlist * lmax, w) bytes (bytes past w and rows past
//   the payload filled with zeros) and the item's digit slice as boxes of
//   8 rows x 128 dimensions of the digit rows viewed as (t_max * 8, width)
//   hi rows and lo rows (zeros past the width), all 128-byte swizzled so
//   that ldmatrix's 8 rows a phase meet 8 distinct bank groups, and all
//   completing on the stage's `full` mbarrier.  The tensor maps are built
//   on the host with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no driver library is linked), and passed as a
//   __grid_constant__ parameter; their shapes and boxes come from the
//   wrapper (ops/ivf_sq_pairs_mega.py::tensor_maps).
// * Eight consumer warps wait for `full`, run the int8 tensor-core MMAs of
//   sq_mma.cuh on the staged chunk (32 rows a warp), score a row chunk
//   after its last column chunk, and arrive on `empty`.  Whole row chunks
//   past the count, and tiles without rows, are written -inf by the
//   consumers on the tile's first item.
// * Widths TMA does not take (w not a multiple of 16, codes or digits not
//   16-byte aligned) and sq6 (its 3-byte groups do not fill the 128-byte
//   box) run the cp.async instance: all 8 warps issue each chunk's copies
//   into a ring and compute (sq_mma.cuh::ring_scan, K3's ring with
//   persistent blocks).  A compile-time variant, not a fallback; its sq8 /
//   sq4 form copies 16-byte windows (VEC only for sq6: sq8 / sq4 rows in
//   whole units go through TMA).
// * The wrapper plans the stages (ops/ivf_sq_pairs.py::stage_plan): one
//   block an SM and the deepest ring; at d = 1536, 6 stages (205 KB) under
//   TMA.  Offsets into the payload are 64-bit: it passes 2^32
//   bytes at the MS MARCO shape (16.1 GB).
// What bounds it on the H100: the list bytes of the tiles (each read once
// a tile); the MMAs and the shared-memory fragment loads stay below it,
// and with TMA no thread spends issue slots on the copies.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sq_mma.cuh"
#include "tma_2d.cuh"

namespace {

using sqm::kNT;
using sqm::kQG;
using sqm::kRows;
using sqm::kSlots;

constexpr int kBoxCols = 128;                    // TMA boxes: 128 bytes wide
constexpr int kBoxRows = 64;                     // code boxes: 64 rows (8 KB)
constexpr int kDigitBoxRows = kQG;               // digit boxes: 8 rows (1 KB)
constexpr int kCodeBytes = kRows * kBoxCols;     // a stage's codes: 32 KB
constexpr int kThreadsTma = 32 + sqm::kThreads;  // a producer warp, 8 consumers
constexpr int kMaxStagesTma = 6;
static_assert(sqm::Geo<sqd::kSQ8>::kCW == kBoxCols && sqm::Geo<sqd::kSQ4>::kCW == kBoxCols,
              "a chunk is four code boxes");

// A stage: the item's codes, then its digit slice (kDims / 128 blocks of
// 2 KB, each a hi and a lo box), 1024-byte aligned for the swizzle.
template <int CODEC>
__host__ __device__ constexpr int stage_tma() {
  return kCodeBytes + kSlots * sqm::Geo<CODEC>::kDims;
}

// A stage's item, written by the producer before it arrives on `full`.
struct Item {
  int tile;  // < 0: no more items
  int lid, cnt, rc, cc;
  int pad[3];
};

// The three tensor maps: the payload as (nlist * lmax, w) bytes, and the
// digit rows as (t_max * 8, width) hi rows and lo rows.
struct Maps {
  CUtensorMap codes, hi, lo;
};

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sqm::smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sqm::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sqm::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = sqm::smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The producer lane: every item of the block's tiles, then the end.  An
// item's code boxes stop at the tile's count (rows of a box past it are
// loaded but never scored); rows of the stage past its boxes hold an
// earlier item's bytes, never scored either.
template <int CODEC>
__device__ __forceinline__ void produce(const Maps* maps, const sqm::RingArgs& a, uint8_t* stages,
                                        Item* items, uint64_t* full, uint64_t* empty) {
  constexpr int dims = sqm::Geo<CODEC>::kDims;
  const int S = a.stages;
  int i = 0;
  for (;;) {
    const int tile = atomicAdd(a.next_tile, 1);
    const bool end = tile >= a.n_tiles;
    int lid = 0;
    const int cnt = end ? 0 : sqm::tile_rows(a, tile, lid);
    const int n_items = cnt > 0 ? (cnt + kRows - 1) / kRows * a.ncc : 1;
    for (int k = 0; k < n_items; ++k, ++i) {
      const int s = i % S;
      bar_wait(&empty[s], ((i / S) & 1) ^ 1);
      const int rc = k / a.ncc, cc = k - rc * a.ncc;
      items[s] = Item{end ? -1 : tile, lid, cnt, rc, cc, {0, 0, 0}};
      if (cnt == 0) {  // the end, or a tile the consumers only clear
        bar_arrive(&full[s]);
        continue;
      }
      const int boxes = (min(kRows, cnt - rc * kRows) + kBoxRows - 1) / kBoxRows;
      bar_expect(&full[s], boxes * kBoxRows * kBoxCols + kSlots * dims);
      uint8_t* st = stages + s * stage_tma<CODEC>();
      const int y = lid * a.lmax + rc * kRows;
      for (int b = 0; b < boxes; ++b)
        tma2d::box(st + b * kBoxRows * kBoxCols, &maps->codes, cc * kBoxCols, y + b * kBoxRows,
                   &full[s]);
      for (int j = 0; j < dims / kBoxCols; ++j) {
        uint8_t* dig = st + kCodeBytes + j * 2 * kDigitBoxRows * kBoxCols;
        const int x = cc * dims + j * kBoxCols;
        tma2d::box(dig, &maps->hi, x, tile * kQG, &full[s]);
        tma2d::box(dig + kDigitBoxRows * kBoxCols, &maps->lo, x, tile * kQG, &full[s]);
      }
    }
    if (end) return;
  }
}

template <int CODEC, bool L2>
__global__ void __launch_bounds__(kThreadsTma, 1)
    ivf_sq_pairs_mega_tma(const __grid_constant__ Maps maps, sqm::RingArgs a,
                          float* __restrict__ out) {
  using G = sqm::Geo<CODEC>;
  constexpr int stage_bytes = stage_tma<CODEC>();
  extern __shared__ int4 smem4[];
  // Stages, 1024-byte aligned for the swizzle; items; barriers.
  uint8_t* stages = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  const int S = a.stages;
  Item* items = reinterpret_cast<Item*>(stages + S * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(items + S);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a.n_tiles = min(a.meta[0], a.t_max);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], sqm::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) produce<CODEC>(&maps, a, stages, items, full, empty);
    return;
  }
  const int ctid = threadIdx.x - 32;
  const int rw = (warp - 1) * sqm::kWarpRows;
  int acc[kNT][4] = {};
  float q[4];
  sqm::RowScalars rsc;
  const int zero[kNT] = {};
  for (int i = 0;; ++i) {
    const int s = i % S;
    bar_wait(&full[s], (i / S) & 1);
    const Item it = items[s];
    if (it.tile < 0) break;
    if (it.rc == 0 && it.cc == 0) {
      sqm::clear_tail(out, it.tile, it.cnt, a.lmax, ctid, sqm::kThreads);
      sqm::load_query(q, a.qs, it.tile);
    }
    if (it.cnt > 0) {
      const int r0 = it.rc * kRows;
      const int64_t slot0 = static_cast<int64_t>(it.lid) * a.lmax;
      if (it.cc == 0) sqm::load_rows<L2>(rsc, a.rs, a.rn, a.mask, slot0, r0 + rw, it.cnt);
      if (rw < it.cnt - r0) {
        const uint8_t* st = stages + s * stage_bytes;
        const int steps = (min(G::kCW, a.w - it.cc * G::kCW) + G::kStep - 1) / G::kStep;
        sqm::mma_chunk<CODEC, CODEC == sqd::kSQ8, true, true>(
            st, kBoxCols, sqm::smem_u32(st + kCodeBytes), kBoxCols, steps, rw, zero, acc);
      }
      if (it.cc == a.ncc - 1)
        sqm::store_rows<L2>(acc, rsc, q,
                            out + (static_cast<int64_t>(it.tile) * kQG + (lane >> 2)) * a.lmax,
                            r0 + rw, a.lmax);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
}

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(sqm::kThreads, 1)
    ivf_sq_pairs_mega_ring(sqm::RingArgs a, float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  sqm::ring_scan<CODEC, VEC, L2>(a, out, reinterpret_cast<uint8_t*>(smem4));
}

// Shared memory the kernels lay out, which the plan's size must cover.
template <int CODEC>
size_t smem_needed(bool tma, bool vec, const sqm::RingArgs& a) {
  const size_t S = a.stages;
  if (tma) return 1024 + S * (stage_tma<CODEC>() + sizeof(Item) + 2 * sizeof(uint64_t));
  const size_t ring =
      vec ? sqm::Ring<CODEC, true>::kStageBytes : sqm::Ring<CODEC, false>::kStageBytes;
  return sqm::kHeadBytes + S * ring;
}

template <typename K>
cudaError_t grid_for(K kernel, int threads, int smem, int t_max, int* grid) {
  int dev, nsm, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (blocks == 0) return cudaErrorInvalidValue;
  *grid = min(blocks * nsm, t_max);
  return cudaSuccess;
}

// A 2D uint8 tensor map: dims[0] bytes a row, dims[1] rows, rows dims[2]
// bytes apart, boxes of dims[3] x dims[4], 128-byte swizzled.
bool encode_map(tma2d::EncodeTiled encode, CUtensorMap* map, const void* base,
                const long long* dims) {
  const cuuint64_t size[2] = {static_cast<cuuint64_t>(dims[0]),
                              static_cast<cuuint64_t>(dims[1])};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(dims[2])};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(dims[3]), static_cast<cuuint32_t>(dims[4])};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), size, stride, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CODEC, bool L2>
cudaError_t launch_tma(const sqm::RingArgs& a, const long long* shape, int smem, float* out,
                       int* grid, cudaStream_t stream) {
  tma2d::EncodeTiled encode = tma2d::encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // shape: the codes' map, then the digit rows' (the lo rows' base is the
  // hi rows' plus the width)
  if (shape[3] != kBoxCols || shape[4] != kBoxRows || shape[8] != kBoxCols ||
      shape[9] != kDigitBoxRows || shape[5] != a.width)
    return cudaErrorInvalidValue;
  Maps maps;
  if (!encode_map(encode, &maps.codes, a.codes, shape) ||
      !encode_map(encode, &maps.hi, a.digits, shape + 5) ||
      !encode_map(encode, &maps.lo, a.digits + a.width, shape + 5))
    return cudaErrorInvalidValue;
  auto kernel = ivf_sq_pairs_mega_tma<CODEC, L2>;
  cudaError_t err = grid_for(kernel, kThreadsTma, smem, a.t_max, grid);
  if (err != cudaSuccess) return err;
  kernel<<<*grid, kThreadsTma, smem, stream>>>(maps, a, out);
  return cudaGetLastError();
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch_ring(const sqm::RingArgs& a, int smem, float* out, int* grid,
                        cudaStream_t stream) {
  auto kernel = ivf_sq_pairs_mega_ring<CODEC, VEC, L2>;
  cudaError_t err = grid_for(kernel, sqm::kThreads, smem, a.t_max, grid);
  if (err != cudaSuccess) return err;
  kernel<<<*grid, sqm::kThreads, smem, stream>>>(a, out);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t dispatch(bool vec, bool l2, bool tma, const sqm::RingArgs& a, const long long* shape,
                     int smem, float* out, int* grid, cudaStream_t s) {
  if (a.stages > (tma ? kMaxStagesTma : sqm::kMaxStages) ||
      static_cast<size_t>(smem) < smem_needed<CODEC>(tma, vec, a))
    return cudaErrorInvalidValue;
  if (tma) {
    if constexpr (CODEC == sqd::kSQ6) {
      return cudaErrorInvalidValue;
    } else {
      return l2 ? launch_tma<CODEC, true>(a, shape, smem, out, grid, s)
                : launch_tma<CODEC, false>(a, shape, smem, out, grid, s);
    }
  }
  if constexpr (CODEC == sqd::kSQ6) {
    if (vec)
      return l2 ? launch_ring<CODEC, true, true>(a, smem, out, grid, s)
                : launch_ring<CODEC, true, false>(a, smem, out, grid, s);
  } else if (vec) {
    return cudaErrorInvalidValue;  // sq8 / sq4 rows in whole units take TMA
  }
  return l2 ? launch_ring<CODEC, false, true>(a, smem, out, grid, s)
            : launch_ring<CODEC, false, false>(a, smem, out, grid, s);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for an unknown codec, a chunk width, box or shared
// memory size that does not match the kernel's, a tensor map the driver
// refuses, or a plan no block fits (cudaErrorSymbolNotFound: no
// cuTensorMapEncodeTiled).  codec: 0 sq8, 1 sq4, 2 sq6.  The caller sizes
// out as (t_max, 8, lmax) and passes t_max >= 1, lmax a multiple of 4,
// 16-byte aligned codes and qs, 8-byte aligned rn and rs, a 4-byte aligned
// mask, vec = 1 only with w a multiple of the unit (16 bytes; 48 for sq6)
// and, for sq8 / sq4, only with tma, dvec = 1 only with width a multiple
// of 16 and 16-byte aligned digits, tma = 1 only for sq8 / sq4 with vec
// and dvec, shape (10 int64, read under tma only: the codes' and
// the digit rows' tensor maps, each its two dimensions, row stride and
// box), chunk, stages and smem from the stage plan, and next_tile one int
// set to 0.  plan (2 ints, or null) receives the stage count and the grid.
extern "C" int dfx_ivf_sq_pairs_mega(const uint8_t* codes, const float* rn, const float* rs,
                                     const int* counts, const int8_t* digits, const float* qs,
                                     const int* meta, const int8_t* mask, int t_max, int nlist,
                                     int lmax, int w, int codec, int l2, int vec, int dvec,
                                     int tma, const long long* shape, int width, int chunk,
                                     int stages, int smem, int* next_tile, float* out,
                                     int* plan, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  sqm::RingArgs a{};
  a.codes = codes;
  a.codes_end = codes + static_cast<int64_t>(nlist) * lmax * w;
  a.rn = rn;
  a.rs = rs;
  a.counts = counts;
  a.digits = digits;
  a.qs = qs;
  a.meta = meta;
  a.mask = reinterpret_cast<const uint8_t*>(mask);
  a.t_max = t_max;
  a.nlist = nlist;
  a.lmax = lmax;
  a.w = w;
  a.width = width;
  a.dvec = dvec;
  a.ncc = (w + chunk - 1) / chunk;
  a.stages = stages;
  a.next_tile = next_tile;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (codec) {
    case sqd::kSQ8:
      if (chunk == sqm::Geo<sqd::kSQ8>::kCW)
        err = dispatch<sqd::kSQ8>(vec, l2, tma, a, shape, smem, out, &grid, s);
      break;
    case sqd::kSQ4:
      if (chunk == sqm::Geo<sqd::kSQ4>::kCW)
        err = dispatch<sqd::kSQ4>(vec, l2, tma, a, shape, smem, out, &grid, s);
      break;
    case sqd::kSQ6:
      if (chunk == sqm::Geo<sqd::kSQ6>::kCW)
        err = dispatch<sqd::kSQ6>(vec, l2, tma, a, shape, smem, out, &grid, s);
      break;
  }
  if (err == cudaSuccess && plan != nullptr) {
    plan[0] = stages;
    plan[1] = grid;
  }
  return static_cast<int>(err);
}
