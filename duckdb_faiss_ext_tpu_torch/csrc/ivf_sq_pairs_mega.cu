// Pair-tile IVF,SQ8/SQ4/SQ6 int8 scan, pipelined (K9), for Hopper
// (sm_90a).  Replaces the TPU kernel duckdb_faiss_ext_tpu/ops/
// pallas_ivf_pairs.py::_pairs_sq_mega_kernel; the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_sq_pairs_mega.py.
//
// Contract: K3's (ivf_sq_pairs.cu), so its raw (t_max, 8, lmax) tiles are
// bit-equal to K3's: codes (nlist, lmax, w) uint8, rn / rs (nlist, lmax)
// fp32, counts (nlist,), digits (t_max * 8, 2, 4 * words) int8, qs (t_max,
// 8, 4) fp32 (su2, c0, base, mu; base +inf (L2) / -inf (IP) on empty
// slots), meta (1 + t_max,) = n_tiles and the tiles' list ids, optional
// mask (nlist, lmax) bytes.  Tiles t >= n_tiles (read on the device) are
// left unwritten.  lmax must be a multiple of 4 and codes 16-byte aligned.
//
// Design.  The TPU kernel walked tps tiles a grid step and kept the copies
// of the next slots - 1 tiles' list blocks in flight while one tile
// computed.  A list block here (2560 x 1536 B = 3.9 MB at the MS MARCO
// shape) is far beyond the 227 KB a block may hold, so the unit in flight
// is a chunk: 256 rows x 192 code bytes of one tile's list.
// * Persistent blocks that fetch their tiles: gridDim.x = the SMs times
//   the blocks an SM holds at the chosen shared memory (one at d = 1536);
//   each block takes the next tile from a device counter (next_tile, zero
//   before the launch) until none below n_tiles is left, so blocks given
//   long lists take fewer tiles.  A block that finds no tile issues no
//   copy.
// * Each block walks one sequence of items (tile, row chunk, column
//   chunk) over its tiles, rows below the tile's count only.  A ring of
//   `stages` shared-memory stages holds items in flight: before item i
//   computes, item i + stages - 1 is issued with cp.async (cp_async.cuh),
//   across tile boundaries, so the next tile's first chunk streams in
//   while the current tile's last one computes.  One commit group an
//   iteration (empty ones too) keeps the waits counted alike in every
//   thread; every issued copy is waited on before its item computes, and
//   the block drains its groups before it exits.
// * The host takes the stage count (2 to 4) that keeps the most blocks on
//   an SM, the deepest ring among those: at d = 1536, 2 stages and one
//   block (160 KB).  Measured on the H100 at the MS MARCO b1024 shape,
//   resident warps mattered more than depth (256 threads a block: 256 x
//   96-byte chunks in 4 stages took 10.4 ms, in 2 stages with two blocks
//   an SM 8.6 ms, 256 x 192-byte chunks in 2 stages 8.3 ms, against K3's
//   7.9 ms), so a block has 512 threads, two a row.
// * A stage carries the chunk's codes (a row every 208 bytes: 52 words, so
//   the 16-byte reads of 8 neighbouring rows hit 32 distinct banks); the
//   row chunk's rn / rs / mask ride with its last column chunk; a tile's
//   16 digit rows (24 KB at d = 1536) ride with its first item into one of
//   `stages` digit buffers (the items in flight span at most that many
//   tiles).  Digits stay slot-major as they land: a 16-byte code unit
//   meets them in one 16-byte broadcast a slot and four __dp4a
//   (sq_digits.cuh::dot_slot_major4).
// * Compute is K3's, split in two: two threads own a row of the chunk, one
//   the 8 int32 dots of queries 0-3 (hi / lo), the other those of queries
//   4-7, across the column chunks, each unpacking the staged units in
//   registers; after the last column chunk each writes its 4 scores with
//   sq_digits.cuh::score (unfused fp32, as K3 and the plain version).
//   Whole row chunks past the count are written -inf without an item.
// * Widths that are not whole units (VEC off) copy each row's
//   16-byte-aligned window around its 192 bytes (13 pieces, the tail past
//   the payload zero-filled) and unpack group by group.
// * Offsets into the payload are 64-bit: it passes 2^32 bytes at the MS
//   MARCO shape (16.1 GB).
// What bounds it on the H100: the __dp4a rate (16 per code word a row) and
// the shared-memory broadcasts feeding it, then the list bytes of the
// tiles (each read once a tile).  int8 tensor cores (mma.sync m16n8k32 /
// wgmma), TMA bulk copies with mbarriers and a producer warp are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "sq_digits.cuh"

namespace {

constexpr int kQG = 8;           // queries per tile
constexpr int kSlots = 2 * kQG;  // hi and lo digit rows
constexpr int kRows = 256;       // rows per chunk
constexpr int kThreads = 512;    // two threads a row, each with half the slots
constexpr int kHalf = kSlots / 2;
constexpr int kCW = 192;         // code bytes per row per chunk: whole 16 / 48-byte
                                 // units and whole 4 / 2 / 3-byte groups
constexpr int kCStride = kCW + 16;  // staged row: the chunk or its aligned window
constexpr int kStageBytes = kRows * kCStride + 2 * kRows * 4 + kRows;  // codes, rn, rs, mask
constexpr int kMaxStages = 4;
static_assert(kStageBytes % 16 == 0, "stages stay 16-byte aligned");

struct Args {
  const uint8_t* codes;
  const uint8_t* codes_end;
  const float* rn;
  const float* rs;
  const int* counts;
  const int8_t* digits;
  const float* qs;
  const int* meta;
  const uint8_t* mask;
  int t_max, nlist, lmax, w;
  int words, words4;  // digit words a row; its shared-memory stride (a multiple of 4)
  int dvec;           // digit rows copy in 16-byte pieces
  int ncc;            // column chunks a row
  int stages;
  int n_tiles;        // set on the device from meta[0]
  int* next_tile;     // the tile counter the blocks fetch from
};

// Position in a block's item sequence; every thread holds the same one.
struct Cursor {
  int tile, lid, cnt, nrc;
  int rc, cc;  // row chunk, column chunk
  int seq;     // ordinal among the block's tiles with rows: digit buffer seq % stages
  bool done;
};

// Shared-memory head: the tiles the block fetched, by seq % kRing (the
// items in flight span at most kMaxStages of them, and the fetching
// cursor holds one more), and a mailbox for the fetch.
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
  for (int i = threadIdx.x; i < kQG * n; i += kThreads) o[(i / n) * a.lmax + i % n] = -INFINITY;
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
// fetched: it runs at least one item ahead, so a next tile, if any, is in
// the ring.
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

constexpr int kRnOffset = kRows * kCStride;  // a stage's rn, then rs, then mask

template <int CODEC, bool VEC>
__device__ __forceinline__ void issue(const Cursor& c, const Args& a, uint8_t* st, int* dig) {
  const int64_t slot0 = static_cast<int64_t>(c.lid) * a.lmax;
  const int r0 = c.rc * kRows, c0 = c.cc * kCW;
  const int nrows = min(kRows, c.cnt - r0);
  const int span = min(kCW, a.w - c0);
  if (VEC) {
    const int pieces = span / 16;
    for (int p = threadIdx.x; p < nrows * pieces; p += kThreads) {
      const int rr = p / pieces, k = p - rr * pieces;
      cpa::copy16(st + rr * kCStride + 16 * k,
                  a.codes + (slot0 + r0 + rr) * a.w + c0 + 16 * k);
    }
  } else {
    constexpr int pieces = kCStride / 16;
    for (int p = threadIdx.x; p < nrows * pieces; p += kThreads) {
      const int rr = p / pieces, k = p - rr * pieces;
      const uint8_t* at = a.codes + (slot0 + r0 + rr) * a.w + c0;
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 15);
      if (16 * k >= mis + span) continue;  // past this row's bytes of the chunk
      const uint8_t* src = at - mis + 16 * k;
      const int64_t left = a.codes_end - src;  // >= 1: src lies before the row's last byte
      cpa::copy16(st + rr * kCStride + 16 * k, src, left >= 16 ? 16 : static_cast<int>(left));
    }
  }
  if (c.cc == a.ncc - 1) {  // rn / rs / mask of the row chunk, with its last column chunk
    float* srn = reinterpret_cast<float*>(st + kRnOffset);
    float* srs = srn + kRows;
    uint8_t* smask = reinterpret_cast<uint8_t*>(srs + kRows);
    const int t = threadIdx.x;
    if (t < nrows) {
      cpa::copy4(srn + t, a.rn + slot0 + r0 + t);
      cpa::copy4(srs + t, a.rs + slot0 + r0 + t);
    }
    if (a.mask != nullptr && 4 * t < nrows) cpa::copy4(smask + 4 * t, a.mask + slot0 + r0 + 4 * t);
  }
  if (c.rc == 0 && c.cc == 0) {  // the tile's 16 digit rows, with its first item
    const int8_t* src = a.digits + static_cast<int64_t>(c.tile) * kSlots * 4 * a.words;
    if (a.dvec) {
      const int per = a.words / 4;
      for (int p = threadIdx.x; p < kSlots * per; p += kThreads) {
        const int s = p / per, k = p - s * per;
        cpa::copy16(dig + s * a.words4 + 4 * k, src + 4 * (static_cast<int64_t>(s) * a.words + 4 * k));
      }
    } else {
      for (int p = threadIdx.x; p < kSlots * a.words; p += kThreads) {
        const int s = p / a.words, k = p - s * a.words;
        cpa::copy4(dig + s * a.words4 + k, src + 4 * (static_cast<int64_t>(s) * a.words + k));
      }
    }
  }
}

// Thread t scores row t % kRows against the digit slots of half t / kRows
// (queries 4h .. 4h + 3, hi and lo).
template <int CODEC, bool VEC, bool L2>
__device__ __forceinline__ void compute(const Cursor& c, const Args& a, const uint8_t* st,
                                        const int* __restrict__ dig, int (&acc)[kHalf],
                                        const float (&q4)[kQG / 2][4], float* __restrict__ out) {
  using U = sqd::Unpack<CODEC>;
  const int r0 = c.rc * kRows, c0 = c.cc * kCW;
  const int nrows = min(kRows, c.cnt - r0);
  const int t = threadIdx.x % kRows;
  dig += (threadIdx.x / kRows) * kHalf * a.words4;
  if (t < nrows) {
    const uint8_t* row = st + t * kCStride;
    const int span = min(kCW, a.w - c0);
    if (VEC) {
      const int u0 = c0 / U::kVecBytes, nu = span / U::kVecBytes;
      for (int j = 0; j < nu; ++j) {
        const uint4* p4 = reinterpret_cast<const uint4*>(row + j * U::kVecBytes);
        uint4 units[U::kVecUnits];
#pragma unroll
        for (int i = 0; i < U::kVecUnits; ++i) units[i] = p4[i];
        int words[U::kVecWords];
        U::from_units(units, words);
#pragma unroll
        for (int i = 0; i < U::kVecWords; i += 4) {
          const int w4[4] = {words[i], words[i + 1], words[i + 2], words[i + 3]};
          sqd::dot_slot_major4<kHalf>(w4, dig, a.words4, (u0 + j) * U::kVecWords + i, acc);
        }
      }
    } else {
      const int64_t slot0 = static_cast<int64_t>(c.lid) * a.lmax;
      const uint8_t* at = a.codes + (slot0 + r0 + t) * a.w + c0;
      const uint8_t* b0 = row + (reinterpret_cast<uintptr_t>(at) & 15);  // byte c0 of the row
      constexpr int gb = U::kGroupBytes;
      const int g1 = min((c0 + kCW) / gb, U::groups(a.w));
      for (int g = c0 / gb; g < g1; ++g)
        sqd::dot_slot_major<kHalf>(U::group_at(b0 + (g * gb - c0), a.w - g * gb), dig, a.words4,
                                   g, acc);
    }
  }
  if (c.cc != a.ncc - 1) return;
  const int r = r0 + t;
  if (r < a.lmax) {
    float* o = out + (static_cast<int64_t>(c.tile) * kQG + (threadIdx.x / kRows) * (kQG / 2)) *
                         a.lmax + r;
    const float* srn = reinterpret_cast<const float*>(st + kRnOffset);
    const float* srs = srn + kRows;
    const uint8_t* smask = reinterpret_cast<const uint8_t*>(srs + kRows);
    if (t < nrows && (a.mask == nullptr || smask[t] != 0)) {
      const float rs_r = srs[t];
      const float rn_r = L2 ? srn[t] : 0.f;
#pragma unroll
      for (int q = 0; q < kQG / 2; ++q)
        o[q * a.lmax] = sqd::score<L2>(acc[2 * q], acc[2 * q + 1], q4[q][0], q4[q][1], q4[q][2],
                                       q4[q][3], rs_r, rn_r);
    } else {
#pragma unroll
      for (int q = 0; q < kQG / 2; ++q) o[q * a.lmax] = -INFINITY;
    }
  }
#pragma unroll
  for (int s = 0; s < kHalf; ++s) acc[s] = 0;
}

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(kThreads) ivf_sq_pairs_mega_kernel(Args a, float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* ring = reinterpret_cast<int*>(smem4);
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4) + kHeadBytes;
  a.n_tiles = min(a.meta[0], a.t_max);
  const int S = a.stages;
  int* digs = reinterpret_cast<int*>(smem + S * kStageBytes);
  const int dig_ints = kSlots * a.words4;
  Cursor is{0, 0, 0, 0, 0, 0, -1, false};
  fetch(is, a, ring, out);  // a block that finds no tile issues nothing
  Cursor cs = is;
  for (int j = 0; j < S - 1; ++j) {  // prologue: S - 1 items in flight
    if (!is.done) {
      issue<CODEC, VEC>(is, a, smem + j * kStageBytes, digs + (is.seq % S) * dig_ints);
      advance(is, a, ring, out);
    }
    cpa::commit();
  }
  int acc[kHalf];
#pragma unroll
  for (int s = 0; s < kHalf; ++s) acc[s] = 0;
  float q4[kQG / 2][4];  // this thread's 4 queries
  for (int i = 0; !cs.done; ++i) {
    if (!is.done) {
      issue<CODEC, VEC>(is, a, smem + ((i + S - 1) % S) * kStageBytes,
                        digs + (is.seq % S) * dig_ints);
      advance(is, a, ring, out);
    }
    cpa::commit();
    cpa::wait_pending(S - 1);  // item i's group has landed
    __syncthreads();
    if (cs.rc == 0 && cs.cc == 0) {
#pragma unroll
      for (int q = 0; q < kQG / 2; ++q) {
        const float4 v = reinterpret_cast<const float4*>(
            a.qs)[static_cast<int64_t>(cs.tile) * kQG + (threadIdx.x / kRows) * (kQG / 2) + q];
        q4[q][0] = v.x;
        q4[q][1] = v.y;
        q4[q][2] = v.z;
        q4[q][3] = v.w;
      }
    }
    compute<CODEC, VEC, L2>(cs, a, smem + (i % S) * kStageBytes, digs + (cs.seq % S) * dig_ints,
                            acc, q4, out);
    __syncthreads();  // stage i % S is free for item i + S
    follow(cs, a, is, ring);
  }
  cpa::wait_pending(0);
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch(Args a, float* out, int* plan, cudaStream_t stream) {
  auto kernel = ivf_sq_pairs_mega_kernel<CODEC, VEC, L2>;
  int dev, smem_max, nsm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t per_stage = kStageBytes + sizeof(int) * kSlots * static_cast<size_t>(a.words4);
  int stages = 0, per_sm = 0;
  for (int st = 2;
       st <= kMaxStages && kHeadBytes + st * per_stage <= static_cast<size_t>(smem_max); ++st) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kHeadBytes + st * per_stage));
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                          kHeadBytes + st * per_stage);
    if (err != cudaSuccess) return err;
    if (blocks > 0 && blocks >= per_sm) {  // the most blocks an SM, then the deepest ring
      per_sm = blocks;
      stages = st;
    }
  }
  if (stages == 0) return cudaErrorInvalidValue;  // digits too wide for two stages
  a.stages = stages;
  const size_t smem = kHeadBytes + stages * per_stage;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = min(per_sm * nsm, a.t_max);
  if (plan != nullptr) {
    plan[0] = stages;
    plan[1] = grid;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a, out);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t dispatch(bool vec, bool l2, const Args& a, float* out, int* plan, cudaStream_t s) {
  if (vec)
    return l2 ? launch<CODEC, true, true>(a, out, plan, s)
              : launch<CODEC, true, false>(a, out, plan, s);
  return l2 ? launch<CODEC, false, true>(a, out, plan, s)
            : launch<CODEC, false, false>(a, out, plan, s);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for an unknown codec or digits too wide for two
// stages of shared memory.  codec: 0 sq8, 1 sq4, 2 sq6.  The caller sizes
// out as (t_max, 8, lmax) and passes t_max >= 1, lmax a multiple of 4,
// 16-byte aligned codes and qs, 4-byte aligned digits and mask, vec = 1
// only with w a multiple of the unit (16 bytes; 48 for sq6), dvec = 1 only
// with 16-byte aligned digits of a multiple of 4 words a row, and
// next_tile one int set to 0.  plan (2 ints, or null) receives the stage
// count and the grid.
extern "C" int dfx_ivf_sq_pairs_mega(const uint8_t* codes, const float* rn, const float* rs,
                                     const int* counts, const int8_t* digits, const float* qs,
                                     const int* meta, const int8_t* mask, int t_max, int nlist,
                                     int lmax, int w, int codec, int l2, int vec, int dvec,
                                     int* next_tile, float* out, int* plan, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  Args a{};
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
  a.ncc = (w + kCW - 1) / kCW;
  a.dvec = dvec;
  a.next_tile = next_tile;
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      a.words = sqd::digit_words<sqd::kSQ8>(w);
      a.words4 = (a.words + 3) & ~3;
      err = dispatch<sqd::kSQ8>(vec, l2, a, out, plan, s);
      break;
    case sqd::kSQ4:
      a.words = sqd::digit_words<sqd::kSQ4>(w);
      a.words4 = (a.words + 3) & ~3;
      err = dispatch<sqd::kSQ4>(vec, l2, a, out, plan, s);
      break;
    case sqd::kSQ6:
      a.words = sqd::digit_words<sqd::kSQ6>(w);
      a.words4 = (a.words + 3) & ~3;
      err = dispatch<sqd::kSQ6>(vec, l2, a, out, plan, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
