// Pair-tile IVF,SQ8/SQ4/SQ6 int8 scan (K3), for Hopper (sm_90a).  Replaces
// the TPU kernel duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
// _pairs_sq_kernel; the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_sq_pairs.py.
//
// Contract: codes (nlist, lmax, w) uint8, rn / rs (nlist, lmax) fp32,
// counts (nlist,), digits (t_max * 8, 2, 4 * words) int8 (each tile's 8
// query slots' hi and lo digits), qs (t_max, 8, 4) fp32 each slot's (su2,
// c0, base, mu) with base +inf (L2) / -inf (IP) on empty slots, meta
// (1 + t_max,) = n_tiles followed by each tile's list id, optional mask
// (nlist, lmax) bytes.  For every tile t < n_tiles with list l = meta[1 + t],
// slot s and row r < lmax: the fp32 score of sq_digits.cuh::score (so -inf
// on empty slots), and -inf where r >= counts[l] or mask[l, r] == 0.  Tiles
// t >= n_tiles return at once and are left unwritten (no pair points into
// them); n_tiles is read on the device, so the host never waits for it.
//
// Design.  The TPU kernel ran one (16, w) x (lmax, w)^T int8 MXU dot per
// tile, the 8 queries' hi and lo digits stacked into 16 rows.  Here one
// block of 256 threads serves one tile, as K7 (ivf_pairs.cu) does: the 16
// digit rows (16 x d bytes, 24 KB at d = 1536) are staged in shared memory
// as [word][slot], each thread owns one list row of a 256-row chunk and
// keeps the 16 int32 dots (8 queries x hi / lo) in registers, reading its
// row once in 16-byte units (48 for sq6), unpacking in registers and
// running 16 __dp4a per code word against broadcast digit words.  Chunks
// wholly past the count are skipped and written -inf.  Offsets into the
// codes are 64-bit.
// What bounds it on the H100: __dp4a throughput (16 per 4 codes of a row)
// and the shared-memory digit broadcasts feeding it, then the code bytes of
// the tiles' lists (a list is read once per tile: 8 queries a read).
// Neighbouring threads read rows w bytes apart, so a warp's loads are not
// coalesced; L1 keeps each row's 128-byte lines between its loads.  int8
// tensor cores (mma.sync m16n8k32, whose M of 16 fits the 16 digit rows,
// or wgmma), cp.async / TMA staging of the code chunks, and several tiles
// of one list per block are left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sq_digits.cuh"

namespace {

constexpr int kQG = 8;          // queries per tile
constexpr int kSlots = 2 * kQG;  // hi and lo digit rows
constexpr int kRows = 256;      // list rows per chunk: one per thread

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(kRows)
ivf_sq_pairs_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ rn,
                    const float* __restrict__ rs, const int* __restrict__ counts,
                    const int8_t* __restrict__ digits, const float* __restrict__ qs,
                    const int* __restrict__ meta, const int8_t* __restrict__ mask,
                    int t_max, int nlist, int lmax, int w, float* __restrict__ out) {
  extern __shared__ int4 dig_s4[];
  int* dig = reinterpret_cast<int*>(dig_s4);
  const int tile = blockIdx.x;
  if (tile >= meta[0]) return;  // padding tile: block-uniform
  const int lid = meta[1 + tile];
  const bool live = lid >= 0 && lid < nlist;
  const int cnt = live ? min(max(counts[lid], 0), lmax) : 0;
  float* o = out + static_cast<int64_t>(tile) * kQG * lmax;
  const int64_t slot0 = static_cast<int64_t>(live ? lid : 0) * lmax;
  const int words = sqd::digit_words<CODEC>(w);
  if (cnt > 0) sqd::stage_digits(digits, tile * kQG, t_max * kQG, kQG, words, dig);
  float q4[kQG][4];
#pragma unroll
  for (int q = 0; q < kQG; ++q) {
    const float4 v = reinterpret_cast<const float4*>(qs)[static_cast<int64_t>(tile) * kQG + q];
    q4[q][0] = v.x; q4[q][1] = v.y; q4[q][2] = v.z; q4[q][3] = v.w;
  }
  __syncthreads();

  for (int row0 = 0; row0 < lmax; row0 += kRows) {
    const int r = row0 + threadIdx.x;
    if (r >= lmax) break;
    if (row0 >= cnt || r >= cnt || (mask && mask[slot0 + r] == 0)) {
#pragma unroll
      for (int q = 0; q < kQG; ++q) o[q * lmax + r] = -INFINITY;
      continue;
    }
    int acc[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[s] = 0;
    sqd::row_dot<CODEC, VEC, kSlots>(codes + (slot0 + r) * w, w, 0, 1, dig, acc);
    const float rs_r = rs[slot0 + r];
    const float rn_r = L2 ? rn[slot0 + r] : 0.f;
#pragma unroll
    for (int q = 0; q < kQG; ++q)
      o[q * lmax + r] = sqd::score<L2>(acc[2 * q], acc[2 * q + 1], q4[q][0], q4[q][1],
                                       q4[q][2], q4[q][3], rs_r, rn_r);
  }
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch(const uint8_t* codes, const float* rn, const float* rs, const int* counts,
                   const int8_t* digits, const float* qs, const int* meta, const int8_t* mask,
                   int t_max, int nlist, int lmax, int w, float* out, cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * kSlots * static_cast<size_t>(sqd::digit_words<CODEC>(w));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_sq_pairs_kernel<CODEC, VEC, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ivf_sq_pairs_kernel<CODEC, VEC, L2><<<t_max, kRows, smem, stream>>>(
      codes, rn, rs, counts, digits, qs, meta, mask, t_max, nlist, lmax, w, out);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t dispatch(bool vec, bool l2, const uint8_t* codes, const float* rn,
                     const float* rs, const int* counts, const int8_t* digits, const float* qs,
                     const int* meta, const int8_t* mask, int t_max, int nlist, int lmax,
                     int w, float* out, cudaStream_t s) {
  if (vec)
    return l2 ? launch<CODEC, true, true>(codes, rn, rs, counts, digits, qs, meta, mask, t_max,
                                          nlist, lmax, w, out, s)
              : launch<CODEC, true, false>(codes, rn, rs, counts, digits, qs, meta, mask,
                                           t_max, nlist, lmax, w, out, s);
  return l2 ? launch<CODEC, false, true>(codes, rn, rs, counts, digits, qs, meta, mask, t_max,
                                         nlist, lmax, w, out, s)
            : launch<CODEC, false, false>(codes, rn, rs, counts, digits, qs, meta, mask, t_max,
                                          nlist, lmax, w, out, s);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or cudaErrorInvalidValue
// for an unknown codec.  codec: 0 sq8, 1 sq4, 2 sq6.  The caller sizes out as
// (t_max, 8, lmax) and passes vec = 1 only with w a multiple of the unit
// (16 bytes; 48 for sq6) and 16-byte aligned codes; digits must be 4-byte
// and qs 16-byte aligned.
extern "C" int dfx_ivf_sq_pairs(const uint8_t* codes, const float* rn, const float* rs,
                                const int* counts, const int8_t* digits, const float* qs,
                                const int* meta, const int8_t* mask, int t_max, int nlist,
                                int lmax, int w, int codec, int l2, int vec, float* out,
                                void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      err = dispatch<sqd::kSQ8>(vec, l2, codes, rn, rs, counts, digits, qs, meta, mask, t_max,
                                nlist, lmax, w, out, s);
      break;
    case sqd::kSQ4:
      err = dispatch<sqd::kSQ4>(vec, l2, codes, rn, rs, counts, digits, qs, meta, mask, t_max,
                                nlist, lmax, w, out, s);
      break;
    case sqd::kSQ6:
      err = dispatch<sqd::kSQ6>(vec, l2, codes, rn, rs, counts, digits, qs, meta, mask, t_max,
                                nlist, lmax, w, out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
