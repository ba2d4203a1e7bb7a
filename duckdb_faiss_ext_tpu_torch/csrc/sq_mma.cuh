// Int8 tensor-core core of the IVF,SQ pair-tile scans for Hopper (sm_90a),
// shared by ivf_sq_pairs.cu (K3) and ivf_sq_pairs_mega.cu (K9): the digit
// and code fragment loads, the mma.sync m16n8k32 loop over a staged chunk,
// the fp32 epilogue, and the cp.async ring that K3 and K9's cp.async
// variant move their chunks through.  The plain version of what they
// compute is ops/ivf_sq_pairs.py::ivf_sq_pairs_scan_reference.
//
// A tile scores its 8 queries' 16 digit rows against rows of its list.  As
// an MMA (mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32):
// * A (16 x 32 a k-step) is the tile's digit rows over the chunk's
//   dimensions, staged with each item beside its code rows as row q =
//   query q's hi digits and row 8 + q its lo digits (digits_t holds them as
//   slot 2q + h: the staging reorders), zero past the digit width: either
//   rows pitched an odd number of 16-byte units, so that the 8 rows an
//   ldmatrix phase reads hit 8 distinct bank groups, or TMA's 128-byte
//   swizzle (8 rows x 128 bytes a box, hi box then lo box).
// * B (32 x 8) is 8 list rows x 32 dimensions.  sq8 rows at 16-byte
//   aligned offsets load with ldmatrix (8 rows x 16 bytes a matrix give each
//   lane the 4 bytes of b0 / b1), then c ^ 0x80 = c - 128.  sq4 / sq6 rows,
//   and sq8 rows staged at a misaligned offset, are unpacked in registers:
//   each lane takes the 2 / 3 / 4 bytes of its own dimensions 4c .. 4c + 3
//   and 16 + 4c .. 16 + 4c + 3 (sq_digits.cuh Unpack::group_at), so digits
//   stay in dimension order and the digit contract does not change.
// * Depth: a chunk's last k-step may pass the row's codes; the digits there
//   are zero (query_digits pads to whole words, the staging past the
//   width), so whatever code bytes the stage holds there add nothing.
// The int32 sums are the same exact integer dots as the plain version's
// float64 ones (|digit| <= 127, |code| <= 128: far below 2^31 at any width
// a row holds), so the raw tiles are bit-equal to it, and K3's to K9's.
//
// Lane (g = lane / 4, c = lane % 4) ends an n-tile holding hi (c0, c1) and
// lo (c2, c3) of query g for the n-tile's rows 2c and 2c + 1; the epilogue
// scores them with sq_digits.cuh::score in registers and stores a float2.
// Eight consumer warps a block each own 32 rows (4 n-tiles) of a 256-row
// chunk and keep 16 int32 accumulators across the column chunks of a row
// chunk; a warp loads each k-step's A fragment once (ldmatrix.x4) and runs
// it against its 4 n-tiles, so digit reads from shared memory are half the
// code bytes'.  rn / rs / mask of a lane's rows are loaded into registers
// with a row chunk's first column chunk and used after its last.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "sq_digits.cuh"

namespace sqm {

constexpr int kQG = 8;             // queries a tile
constexpr int kSlots = 2 * kQG;    // digit rows: hi and lo
constexpr int kRows = 256;         // list rows a chunk
constexpr int kWarps = 8;          // consumer warps a block
constexpr int kWarpRows = kRows / kWarps;
constexpr int kNT = kWarpRows / 8;  // n-tiles of 8 rows a warp
constexpr int kStepDims = 32;      // dimensions a k-step

// Code bytes a row per chunk (whole k-steps and 16-byte pieces; 128 is the
// TMA box's width) and per 32-dimension k-step; the chunk's dimensions.
template <int CODEC>
struct Geo;
template <>
struct Geo<sqd::kSQ8> {
  static constexpr int kCW = 128, kStep = 32, kDims = 128;
};
template <>
struct Geo<sqd::kSQ4> {
  static constexpr int kCW = 128, kStep = 16, kDims = 256;
};
template <>
struct Geo<sqd::kSQ6> {
  static constexpr int kCW = 96, kStep = 24, kDims = 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Offset of byte x of staged code row r: rows `pitch` apart, or (SWZ)
// TMA's 128-byte swizzle, 128-byte rows whose 16-byte units are permuted
// by the row's low three bits.
template <bool SWZ>
__device__ __forceinline__ int staged(int r, int x, int pitch) {
  return SWZ ? r * 128 + ((((x >> 4) ^ r) & 7) << 4) + (x & 15) : r * pitch + x;
}

// Offset of dimension x of staged digit row `row` (hi rows 0-7, lo rows
// 8-15): rows `dpitch` apart, or (SWZ) 128-dimension column blocks of 2 KB,
// each two 8-row TMA boxes, swizzled as code rows.
template <bool SWZ>
__device__ __forceinline__ int digit_at(int row, int x, int dpitch) {
  return SWZ ? (x >> 7) * 2048 + staged<true>(row, x & 127, 128) : row * dpitch + x;
}

// acc[j] += A (the item's digit rows at shared address `dig`, `steps`
// k-steps) x B (staged rows rw + 8j .. rw + 8j + 7 of the chunk at `st`),
// for the warp's n-tiles.  LDSM: sq8 rows at 16-byte aligned offsets;
// otherwise off[j] is where lane's row of n-tile j starts in its staged row
// (a misaligned window's offset, else 0).  CSWZ / DSWZ: the code / digit
// rows are swizzled (staged / digit_at).
template <int CODEC, bool LDSM, bool CSWZ, bool DSWZ>
__device__ __forceinline__ void mma_chunk(const uint8_t* st, int pitch, uint32_t dig, int dpitch,
                                          int steps, int rw, const int (&off)[kNT],
                                          int (&acc)[kNT][4]) {
  using G = Geo<CODEC>;
  using U = sqd::Unpack<CODEC>;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  // ldmatrix.x4 of A: lanes 0-7 / 8-15 / 16-23 / 24-31 address rows 0-7 /
  // 8-15 / 0-7 / 8-15 at dimensions +0 / +0 / +16 / +16: a0 .. a3.
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), ax = 16 * (lane >> 4);
  const uint32_t st_s = smem_u32(st);
#pragma unroll
  for (int ks = 0; ks < G::kCW / G::kStep; ++ks) {
    if (ks >= steps) break;
    uint32_t a[4];
    ldsm4(dig + digit_at<DSWZ>(arow, ax + kStepDims * ks, dpitch), a);
    if constexpr (LDSM) {
      // One ldmatrix.x4 gives b0 / b1 of two n-tiles: lanes 0-7 / 8-15 /
      // 16-23 / 24-31 address rows of n-tile j / j / j+1 / j+1 at bytes
      // +0 / +16 / +0 / +16.
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        const int r = rw + 8 * j + (lane & 7) + 8 * (lane >> 4);
        uint32_t b[4];
        ldsm4(st_s + staged<CSWZ>(r, G::kStep * ks + 16 * ((lane >> 3) & 1), pitch), b);
        mma(acc[j], a, b[0] ^ 0x80808080u, b[1] ^ 0x80808080u);
        mma(acc[j + 1], a, b[2] ^ 0x80808080u, b[3] ^ 0x80808080u);
      }
    } else {
      // bytes holding a lane's dimensions 4c .. 4c + 3, and how far on
      // dimension 16 + 4c starts: sq8 4 / 16, sq4 2 / 8, sq6 3 / 12 (a
      // swizzled sq4 group stays inside one 16-byte unit)
      constexpr int gb = CODEC == sqd::kSQ8 ? 4 : CODEC == sqd::kSQ4 ? 2 : 3;
      static_assert(!CSWZ || CODEC == sqd::kSQ4, "groups inside swizzled units");
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int r = rw + 8 * j + g;
        const int x = off[j] + G::kStep * ks + gb * c;
        const uint32_t b0 =
            static_cast<uint32_t>(U::group_at(st + staged<CSWZ>(r, x, pitch), 4));
        const uint32_t b1 =
            static_cast<uint32_t>(U::group_at(st + staged<CSWZ>(r, x + 4 * gb, pitch), 4));
        mma(acc[j], a, b0, b1);
      }
    }
  }
}

// A lane's row scalars for one row chunk: rows rbase + 8j + 2c and + 1.
struct RowScalars {
  float2 rs[kNT], rn[kNT];
  uint32_t live;  // bit 2j + e: row 8j + 2c + e is below the count and unmasked
};

// Loads them (lmax even, so rows 2c and 2c + 1 share an aligned pair).
template <bool L2>
__device__ __forceinline__ void load_rows(RowScalars& s, const float* __restrict__ rs,
                                          const float* __restrict__ rn,
                                          const uint8_t* __restrict__ mask, int64_t slot0,
                                          int rbase, int cnt) {
  const int c = threadIdx.x & 3;
  s.live = 0;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int r = rbase + 8 * j + 2 * c;
    s.rs[j] = s.rn[j] = make_float2(0.f, 0.f);
    if (r >= cnt) continue;
    s.rs[j] = __ldg(reinterpret_cast<const float2*>(rs + slot0 + r));
    if (L2) s.rn[j] = __ldg(reinterpret_cast<const float2*>(rn + slot0 + r));
    uint32_t m = 0x0101u;
    if (mask != nullptr)
      m = __ldg(reinterpret_cast<const unsigned short*>(mask + slot0 + r));
    const uint32_t l0 = (m & 0xFFu) != 0, l1 = r + 1 < cnt && (m >> 8) != 0;
    s.live |= (l0 | l1 << 1) << (2 * j);
  }
}

// Scores the lane's 8 (query g, row) pairs of the row chunk into `o`, the
// (tile, g) output row, -inf where the row is past the count or masked,
// and zeroes the accumulators.
template <bool L2>
__device__ __forceinline__ void store_rows(int (&acc)[kNT][4], const RowScalars& s,
                                           const float (&q)[4], float* __restrict__ o,
                                           int rbase, int lmax) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int r = rbase + 8 * j + 2 * c;
    if (r < lmax) {
      float2 v;
      v.x = (s.live >> (2 * j)) & 1u
                ? sqd::score<L2>(acc[j][0], acc[j][2], q[0], q[1], q[2], q[3], s.rs[j].x,
                                 s.rn[j].x)
                : -INFINITY;
      v.y = (s.live >> (2 * j + 1)) & 1u
                ? sqd::score<L2>(acc[j][1], acc[j][3], q[0], q[1], q[2], q[3], s.rs[j].y,
                                 s.rn[j].y)
                : -INFINITY;
      *reinterpret_cast<float2*>(o + r) = v;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  }
}

__device__ __forceinline__ void load_query(float (&q)[4], const float* __restrict__ qs, int tile) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(qs) + static_cast<int64_t>(tile) * kQG +
                         ((threadIdx.x & 31) >> 2));
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
  q[3] = v.w;
}

// Rows of whole chunks at or past a tile's count: -inf, no item (the whole
// tile when cnt == 0).
__device__ __forceinline__ void clear_tail(float* out, int tile, int cnt, int lmax, int tid,
                                           int nthreads) {
  const int from = (cnt + kRows - 1) / kRows * kRows;
  const int n = lmax - from;
  float* o = out + static_cast<int64_t>(tile) * kQG * lmax + from;
  for (int i = tid; i < kQG * n; i += nthreads) o[(i / n) * lmax + i % n] = -INFINITY;
}

// ---- The cp.async ring: K3 (one tile a block) and K9's cp.async variant
// (persistent blocks fetching tiles from a device counter).

constexpr int kThreads = 32 * kWarps;  // every warp copies and computes
constexpr int kMaxStages = 4;
constexpr int kRing = kMaxStages + 1;  // tile ids of the items in flight, and one more
constexpr int kHeadBytes = 64;         // the tile ring and the fetch mailbox
static_assert(4 * (kRing + 1) <= kHeadBytes, "the head holds the ring");

struct RingArgs {
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
  int width;  // digit bytes a row
  int dvec;   // digit rows copy in 16-byte pieces
  int ncc;            // column chunks a row
  int stages;
  int n_tiles;     // set on the device from meta[0]
  int* next_tile;  // the tile counter persistent blocks fetch from; null: tile blockIdx.x
};

// The ring's stage: 256 code rows (VEC sq8 / sq4: 128-byte rows swizzled
// as TMA swizzles them; otherwise the chunk or its 16-byte aligned window,
// kCW + 16 bytes a row), then the item's 16 digit rows (kDims + 16 bytes a
// row, an odd number of 16-byte units).
template <int CODEC, bool VEC>
struct Ring {
  static constexpr bool kSwz = VEC && CODEC != sqd::kSQ6;
  static constexpr int kPitch = kSwz ? 128 : Geo<CODEC>::kCW + 16;
  static constexpr int kDigitPitch = Geo<CODEC>::kDims + 16;
  static constexpr int kCodeBytes = kRows * kPitch;
  static constexpr int kStageBytes = kCodeBytes + kSlots * kDigitPitch;
  static_assert(kStageBytes % 16 == 0, "stages stay 16-byte aligned");
};

// Position in a block's item sequence (tile, row chunk, column chunk);
// every thread holds the same one.
struct Cursor {
  int tile, lid, cnt, nrc;
  int rc, cc;
  int seq;  // ordinal among the block's tiles with rows
  bool done, fetched;
};

__device__ __forceinline__ int tile_rows(const RingArgs& a, int tile, int& lid) {
  lid = a.meta[1 + tile];
  const bool live = lid >= 0 && lid < a.nlist;
  return live ? min(max(a.counts[lid], 0), a.lmax) : 0;
}

// The fetching cursor's next tile with rows (tiles without rows are written
// -inf on the way), or done.  Every thread calls it.
__device__ __forceinline__ void fetch(Cursor& c, const RingArgs& a, int* ring, float* out) {
  for (;;) {
    int tile;
    if (a.next_tile == nullptr) {
      tile = c.fetched ? a.n_tiles : blockIdx.x;
      c.fetched = true;
    } else {
      if (threadIdx.x == 0) ring[kRing] = atomicAdd(a.next_tile, 1);
      __syncthreads();
      tile = ring[kRing];
      __syncthreads();  // the mailbox is free again
    }
    if (tile >= a.n_tiles) {
      c.done = true;
      return;
    }
    int lid;
    const int cnt = tile_rows(a, tile, lid);
    clear_tail(out, tile, cnt, a.lmax, threadIdx.x, kThreads);
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
__device__ __forceinline__ void advance(Cursor& c, const RingArgs& a, int* ring, float* out) {
  if (++c.cc < a.ncc) return;
  c.cc = 0;
  if (++c.rc < c.nrc) return;
  fetch(c, a, ring, out);
}

// The computing cursor's next item, through the tiles the issuing cursor
// fetched: it runs at least one item ahead, so a next tile, if any, is in
// the ring.
__device__ __forceinline__ void follow(Cursor& c, const RingArgs& a, const Cursor& lead,
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

// The item's digit slice: dimensions [k0, k0 + kDims) of the tile's 16
// digit rows (digits_t rows 16 tile + s, slot s = 2q + h) into shared rows
// h * 8 + q, zero-filled past the width; 16-byte pieces (dvec) or 4-byte
// ones.
template <int CODEC, bool VEC>
__device__ __forceinline__ void copy_digits(const RingArgs& a, int tile, int k0, uint8_t* dst) {
  constexpr int dims = Geo<CODEC>::kDims, dp = Ring<CODEC, VEC>::kDigitPitch;
  const int8_t* src = a.digits + static_cast<int64_t>(tile) * kSlots * a.width;
  if (a.dvec) {
    constexpr int per = dims / 16;
    for (int p = threadIdx.x; p < kSlots * per; p += kThreads) {
      const int s = p / per, at = k0 + 16 * (p % per);
      const bool in = at < a.width;  // the width is a multiple of 16
      cpa::copy16(dst + ((s & 1) * kQG + (s >> 1)) * dp + (at - k0),
                  src + s * a.width + (in ? at : 0), in ? 16 : 0);
    }
  } else {
    constexpr int per = dims / 4;
    for (int p = threadIdx.x; p < kSlots * per; p += kThreads) {
      const int s = p / per, at = k0 + 4 * (p % per);
      const bool in = at < a.width;  // the width is a multiple of 4
      cpa::copy4(dst + ((s & 1) * kQG + (s >> 1)) * dp + (at - k0),
                 src + s * a.width + (in ? at : 0), in ? 4 : 0);
    }
  }
}

// Issues the cursor's item into stage `st`: its code rows and digit
// slice.  VEC: the chunk's rows in 16-byte pieces from their aligned
// starts; otherwise each row's 16-byte aligned window around its bytes of
// the chunk, the tail past the payload zero-filled.
template <int CODEC, bool VEC>
__device__ __forceinline__ void issue(const Cursor& c, const RingArgs& a, uint8_t* st) {
  using R = Ring<CODEC, VEC>;
  constexpr int CW = Geo<CODEC>::kCW;
  const int64_t slot0 = static_cast<int64_t>(c.lid) * a.lmax;
  const int r0 = c.rc * kRows, c0 = c.cc * CW;
  const int nrows = min(kRows, c.cnt - r0);
  const int span = min(CW, a.w - c0);
  const uint8_t* rows = a.codes + (slot0 + r0) * a.w + c0;
  if (VEC && span == CW) {  // whole chunks: the pieces a row known at compile time
    constexpr int pieces = CW / 16;
    for (int p = threadIdx.x; p < nrows * pieces; p += kThreads) {
      const int rr = p / pieces, k = p % pieces;
      cpa::copy16(st + staged<R::kSwz>(rr, 16 * k, R::kPitch),
                  rows + static_cast<int64_t>(rr) * a.w + 16 * k);
    }
  } else if (VEC) {
    const int pieces = span / 16;
    for (int p = threadIdx.x; p < nrows * pieces; p += kThreads) {
      const int rr = p / pieces, k = p - rr * pieces;
      cpa::copy16(st + staged<R::kSwz>(rr, 16 * k, R::kPitch),
                  rows + static_cast<int64_t>(rr) * a.w + 16 * k);
    }
  } else {
    constexpr int pieces = R::kPitch / 16;
    for (int p = threadIdx.x; p < nrows * pieces; p += kThreads) {
      const int rr = p / pieces, k = p % pieces;
      const uint8_t* at = rows + static_cast<int64_t>(rr) * a.w;
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 15);
      if (16 * k >= mis + span) continue;  // past this row's bytes of the chunk
      const uint8_t* src = at - mis + 16 * k;
      const int64_t left = a.codes_end - src;  // >= 1: src lies before the row's last byte
      cpa::copy16(st + rr * R::kPitch + 16 * k, src, left >= 16 ? 16 : static_cast<int>(left));
    }
  }
  copy_digits<CODEC, VEC>(a, c.tile, c.cc * Geo<CODEC>::kDims, st + R::kCodeBytes);
}

// The warp's share of the cursor's item: its rows' MMAs, their scalars with
// a row chunk's first column chunk, their scores after its last.
template <int CODEC, bool VEC, bool L2>
__device__ __forceinline__ void compute(const Cursor& c, const RingArgs& a, const uint8_t* st,
                                        RowScalars& rsc, const float (&q)[4], int (&acc)[kNT][4],
                                        float* __restrict__ out) {
  using G = Geo<CODEC>;
  using R = Ring<CODEC, VEC>;
  const int rw = (threadIdx.x >> 5) * kWarpRows;
  const int r0 = c.rc * kRows;
  const int64_t slot0 = static_cast<int64_t>(c.lid) * a.lmax;
  if (c.cc == 0) load_rows<L2>(rsc, a.rs, a.rn, a.mask, slot0, r0 + rw, c.cnt);
  if (rw < c.cnt - r0) {
    const int c0 = c.cc * G::kCW;
    const int steps = (min(G::kCW, a.w - c0) + G::kStep - 1) / G::kStep;
    int off[kNT] = {};
    if (!VEC) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int r = r0 + rw + 8 * j + ((threadIdx.x & 31) >> 2);
        off[j] = static_cast<int>(
            reinterpret_cast<uintptr_t>(a.codes + (slot0 + r) * a.w + c0) & 15);
      }
    }
    mma_chunk<CODEC, VEC && CODEC == sqd::kSQ8, R::kSwz, false>(
        st, R::kPitch, smem_u32(st + R::kCodeBytes), R::kDigitPitch, steps, rw, off, acc);
  }
  if (c.cc == a.ncc - 1)
    store_rows<L2>(acc, rsc, q,
                   out + (static_cast<int64_t>(c.tile) * kQG + ((threadIdx.x & 31) >> 2)) * a.lmax,
                   r0 + rw, a.lmax);
}

// The ring: `stages` shared-memory stages of one item each; before item i
// computes, item i + stages - 1 is issued (across tile boundaries in the
// persistent form), one commit group an iteration (empty ones too) so every
// thread counts its waits alike.  Shared memory: the head, then the stages.
template <int CODEC, bool VEC, bool L2>
__device__ __forceinline__ void ring_scan(RingArgs a, float* __restrict__ out, uint8_t* smem) {
  constexpr int stage_bytes = Ring<CODEC, VEC>::kStageBytes;
  int* ring = reinterpret_cast<int*>(smem);
  uint8_t* stages = smem + kHeadBytes;
  const int S = a.stages;
  a.n_tiles = min(a.meta[0], a.t_max);
  Cursor is{0, 0, 0, 0, 0, 0, -1, false, false};
  fetch(is, a, ring, out);  // a block that finds no tile issues nothing
  Cursor cs = is;
  for (int j = 0; j < S - 1; ++j) {  // prologue: S - 1 items in flight
    if (!is.done) {
      issue<CODEC, VEC>(is, a, stages + j * stage_bytes);
      advance(is, a, ring, out);
    }
    cpa::commit();
  }
  int acc[kNT][4] = {};
  float q[4];
  RowScalars rsc;
  for (int i = 0; !cs.done; ++i) {
    if (!is.done) {
      issue<CODEC, VEC>(is, a, stages + ((i + S - 1) % S) * stage_bytes);
      advance(is, a, ring, out);
    }
    cpa::commit();
    cpa::wait_pending(S - 1);  // item i's group has landed
    __syncthreads();
    if (cs.rc == 0 && cs.cc == 0) load_query(q, a.qs, cs.tile);
    compute<CODEC, VEC, L2>(cs, a, stages + (i % S) * stage_bytes, rsc, q, acc, out);
    __syncthreads();  // stage i % S is free for item i + S
    follow(cs, a, is, ring);
  }
  cpa::wait_pending(0);
}

}  // namespace sqm
