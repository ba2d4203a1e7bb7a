// Unpack-and-dot of packed SQ codes against int8 query digits (K4), shared
// by the IVF,SQ kernels for Hopper (sm_90a): ivf_sq_scan.cu (K2) and
// sq_spill.cu (K5) dot with __dp4a here, and decode for their fp32
// rescores; ivf_sq_pairs.cu (K3) and
// ivf_sq_pairs_mega.cu (K9) take the unpack helpers and the epilogue into
// their int8 tensor-core core (sq_mma.cuh).  Replaces the in-kernel helper
// duckdb_faiss_ext_tpu/ops/sq_digits.py::sq_block_digit_dot; the plain torch
// version is duckdb_faiss_ext_tpu_torch/ops/sq_digits.py::digit_dots.
//
// Codes.  A row of w bytes packs the codes of one vector:
//   sq8: one code a byte, entering the dot as c' = c ^ 0x80 = c - 128;
//   sq4: two a byte, the low nibble the even dimension (raw 0..15);
//   sq6: four per 3 bytes in big-endian bit order,
//        b0 = c0 << 2 | c1 >> 4, b1 = (c1 & 15) << 4 | c2 >> 2,
//        b2 = (c2 & 3) << 6 | c3 (raw 0..63).
// The unpack builds 32-bit words of four int8 codes of consecutive
// dimensions, in registers, and __dp4a multiplies each against the word
// of four query digits of the same dimensions, accumulating in int32.
// Digits stay in dimension order (zero past the row's codes, so a pad code
// adds nothing): the TPU kernel's even/odd and plane-major query packing,
// and its bf16 cast of the operands, followed from Mosaic layouts and are
// not carried over.  Every dot is an exact integer: |digit| <= 127 and
// |code| <= 128 over at most a few thousand dimensions stay far below 2^31.
//
// Two ways through a row: VEC reads 16-byte units (sq6: three of them, 48
// bytes = 64 codes) and needs w a multiple of the unit and 16-byte aligned
// rows; the scalar way reads one group of four codes at a time (4, 2 or 3
// bytes), with bytes at or past w read as 0.  Rows are read from device
// memory (vec, group) or from rows already staged in shared memory
// (from_units, group_at).
//
// Shared-memory digit layout of dot_word: [word][slot] int32, S slots a
// word; slot 2q holds query q's hi digits, slot 2q + 1 its lo digits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sqd {

enum Codec { kSQ8 = 0, kSQ4 = 1, kSQ6 = 2 };

template <int CODEC>
struct Unpack;

template <>
struct Unpack<kSQ8> {
  static constexpr int kVecBytes = 16;
  static constexpr int kVecUnits = 1;
  static constexpr int kVecWords = 4;
  static constexpr int kGroupBytes = 4;
  __device__ static __forceinline__ int groups(int w) { return (w + 3) >> 2; }
  // The group whose first byte is p, with avail bytes left in the row.
  __device__ static __forceinline__ int group_at(const uint8_t* p, int avail) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < avail) v |= static_cast<uint32_t>(p[i]) << (8 * i);
    return static_cast<int>(v ^ 0x80808080u);
  }
  __device__ static __forceinline__ int group(const uint8_t* row, int g, int w) {
    return group_at(row + (g << 2), w - (g << 2));
  }
  __device__ static __forceinline__ void from_units(const uint4 (&u)[kVecUnits],
                                                    int (&out)[kVecWords]) {
    out[0] = static_cast<int>(u[0].x ^ 0x80808080u);
    out[1] = static_cast<int>(u[0].y ^ 0x80808080u);
    out[2] = static_cast<int>(u[0].z ^ 0x80808080u);
    out[3] = static_cast<int>(u[0].w ^ 0x80808080u);
  }
  __device__ static __forceinline__ void vec(const uint8_t* p, int (&out)[kVecWords]) {
    const uint4 u[kVecUnits] = {__ldg(reinterpret_cast<const uint4*>(p))};
    from_units(u, out);
  }
};

template <>
struct Unpack<kSQ4> {
  static constexpr int kVecBytes = 16;
  static constexpr int kVecUnits = 1;
  static constexpr int kVecWords = 8;
  static constexpr int kGroupBytes = 2;
  __device__ static __forceinline__ int groups(int w) { return (w + 1) >> 1; }
  __device__ static __forceinline__ int group_at(const uint8_t* p, int avail) {
    const uint32_t b0 = p[0];
    const uint32_t b1 = avail > 1 ? p[1] : 0u;
    return static_cast<int>((b0 & 15u) | (b0 >> 4) << 8 | (b1 & 15u) << 16 | (b1 >> 4) << 24);
  }
  __device__ static __forceinline__ int group(const uint8_t* row, int g, int w) {
    return group_at(row + 2 * g, w - 2 * g);
  }
  __device__ static __forceinline__ void vec(const uint8_t* p, int (&out)[kVecWords]) {
    const uint4 u[kVecUnits] = {__ldg(reinterpret_cast<const uint4*>(p))};
    from_units(u, out);
  }
  // 4 bytes = dims 8j .. 8j+7: low nibbles are the even dims, high nibbles
  // the odd ones; interleave them back into dimension order.
  __device__ static __forceinline__ void from_units(const uint4 (&u)[kVecUnits],
                                                    int (&out)[kVecWords]) {
    const uint32_t x[4] = {u[0].x, u[0].y, u[0].z, u[0].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = x[j] & 0x0F0F0F0Fu;
      const uint32_t hi = (x[j] >> 4) & 0x0F0F0F0Fu;
      out[2 * j] = static_cast<int>(__byte_perm(lo, hi, 0x5140));
      out[2 * j + 1] = static_cast<int>(__byte_perm(lo, hi, 0x7362));
    }
  }
};

template <>
struct Unpack<kSQ6> {
  static constexpr int kVecBytes = 48;
  static constexpr int kVecUnits = 3;
  static constexpr int kVecWords = 16;
  static constexpr int kGroupBytes = 3;
  __device__ static __forceinline__ int groups(int w) { return w / 3; }
  __device__ static __forceinline__ int codes(uint32_t b0, uint32_t b1, uint32_t b2) {
    const uint32_t v = b0 << 16 | b1 << 8 | b2;
    return static_cast<int>((v >> 18) | ((v >> 12) & 63u) << 8 | ((v >> 6) & 63u) << 16 |
                            (v & 63u) << 24);
  }
  __device__ static __forceinline__ int group_at(const uint8_t* p, int) {
    return codes(p[0], p[1], p[2]);
  }
  __device__ static __forceinline__ int group(const uint8_t* row, int g, int w) {
    return group_at(row + 3 * g, w - 3 * g);
  }
  __device__ static __forceinline__ void vec(const uint8_t* p, int (&out)[kVecWords]) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
    const uint4 v[kVecUnits] = {__ldg(p4), __ldg(p4 + 1), __ldg(p4 + 2)};
    from_units(v, out);
  }
  __device__ static __forceinline__ void from_units(const uint4 (&v)[kVecUnits],
                                                    int (&out)[kVecWords]) {
    const uint4 a = v[0], b = v[1], c = v[2];
    const uint32_t u[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = 3 * j;  // constant after unrolling: the shifts fold
      out[j] = codes((u[k >> 2] >> (8 * (k & 3))) & 0xFFu,
                     (u[(k + 1) >> 2] >> (8 * ((k + 1) & 3))) & 0xFFu,
                     (u[(k + 2) >> 2] >> (8 * ((k + 2) & 3))) & 0xFFu);
    }
  }
};

// Units of a row: 16/48-byte units (VEC) or groups of four codes.
template <int CODEC, bool VEC>
__device__ __forceinline__ int row_units(int w) {
  return VEC ? w / Unpack<CODEC>::kVecBytes : Unpack<CODEC>::groups(w);
}

// Words of four digits a row needs: the digit width over 4.
template <int CODEC>
__host__ __device__ __forceinline__ int digit_words(int w) {
  return CODEC == kSQ8 ? (w + 3) / 4 : CODEC == kSQ4 ? (w + 1) / 2 : w / 3;
}

// acc[s] += digits of slot s . codes of word `word`, for one code word.
template <int S>
__device__ __forceinline__ void dot_word(int code, const int* __restrict__ dig, int word,
                                         int (&acc)[S]) {
  const int* d = dig + word * S;
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const int4 v = *reinterpret_cast<const int4*>(d + s);
      acc[s] = __dp4a(code, v.x, acc[s]);
      acc[s + 1] = __dp4a(code, v.y, acc[s + 1]);
      acc[s + 2] = __dp4a(code, v.z, acc[s + 2]);
      acc[s + 3] = __dp4a(code, v.w, acc[s + 3]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = __dp4a(code, d[s], acc[s]);
  }
}

// Units u0, u0 + ustep, ... of one row, dotted against the S digit slots.
template <int CODEC, bool VEC, int S>
__device__ __forceinline__ void row_dot(const uint8_t* __restrict__ row, int w, int u0,
                                        int ustep, const int* __restrict__ dig,
                                        int (&acc)[S]) {
  using U = Unpack<CODEC>;
  const int units = row_units<CODEC, VEC>(w);
  for (int u = u0; u < units; u += ustep) {
    if (VEC) {
      int words[U::kVecWords];
      U::vec(row + static_cast<int64_t>(u) * U::kVecBytes, words);
#pragma unroll
      for (int i = 0; i < U::kVecWords; ++i) dot_word<S>(words[i], dig, u * U::kVecWords + i, acc);
    } else {
      dot_word<S>(U::group(row, u, w), dig, u, acc);
    }
  }
}

// Stage Q queries' digits, (Q, 2, 4 * words) int8 rows in global memory, as
// [word][2q + hi/lo] int32 in shared memory; slots of queries at or past
// nvalid are zero.  Call with every thread of the block, then sync.
__device__ __forceinline__ void stage_digits(const int8_t* __restrict__ digits, int q0,
                                             int nvalid, int Q, int words, int* dig) {
  const int slots = 2 * Q;
  for (int i = threadIdx.x; i < words * slots; i += blockDim.x) {
    const int word = i / slots, s = i % slots, q = q0 + s / 2;
    int v = 0;
    if (q < nvalid)
      v = reinterpret_cast<const int*>(digits + (static_cast<int64_t>(q) * 2 + (s & 1)) *
                                                    (4 * static_cast<int64_t>(words)))[word];
    dig[i] = v;
  }
}

// The fp32 score of one (query, row) from its exact digit dots, in the JAX
// package's order of operations and without contraction into FMAs, so it
// equals the plain version's torch arithmetic:
//   u.c = su2 * (128 * hi + lo) + c0 + mu * rs
//   IP: base + u.c        L2: -max(base - 2 u.c + rn, 0)
template <bool L2>
__device__ __forceinline__ float score(int hi, int lo, float su2, float c0, float base,
                                       float mu, float rs, float rn) {
  const float t = __fadd_rn(__fmul_rn(128.f, __int2float_rn(hi)), __int2float_rn(lo));
  const float uc = __fadd_rn(__fadd_rn(__fmul_rn(su2, t), c0), __fmul_rn(mu, rs));
  if (!L2) return __fadd_rn(base, uc);
  return -fmaxf(__fadd_rn(__fsub_rn(base, __fmul_rn(2.f, uc)), rn), 0.f);
}

// Decoded value of dimension `dim` from its raw code c (ops/sq.py::
// sq_decode's arithmetic, c * scale + vmin without contraction): the fp32
// rescores of K5 (sq_spill.cu) and K2 (ivf_sq_scan.cu) decode with it.
__device__ __forceinline__ float decode(uint32_t c, const float* scale, const float* vmin,
                                        int dim) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), scale[dim]), vmin[dim]);
}

}  // namespace sqd
