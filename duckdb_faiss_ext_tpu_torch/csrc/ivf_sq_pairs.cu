// Pair-tile IVF,SQ8/SQ4/SQ6 int8 scan (K3), for Hopper (sm_90a).  Replaces
// the TPU kernel duckdb_faiss_ext_tpu/ops/pallas_ivf_pairs.py::
// _pairs_sq_kernel; the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_sq_pairs.py.
//
// Contract: codes (nlist, lmax, w) uint8, rn / rs (nlist, lmax) fp32,
// counts (nlist,), digits (t_max * 8, 2, width) int8 (each tile's 8 query
// slots' hi and lo digits, width a multiple of 4), qs (t_max, 8, 4) fp32
// each slot's (su2, c0, base, mu) with base +inf (L2) / -inf (IP) on empty
// slots, meta (1 + t_max,) = n_tiles followed by each tile's list id,
// optional mask (nlist, lmax) bytes.  For every tile t < n_tiles with list
// l = meta[1 + t], slot s and row r < lmax: the fp32 score of
// sq_digits.cuh::score (so -inf on empty slots), and -inf where r >=
// counts[l] or mask[l, r] == 0.  Tiles t >= n_tiles return at once and are
// left unwritten (no pair points into them); n_tiles is read on the device,
// so the host never waits for it.  lmax is a multiple of 4 and rn / rs
// are 8-byte aligned (a lane loads two rows' scalars as one float2).
//
// Design.  The TPU kernel ran one (16, w) x (lmax, w)^T int8 MXU dot per
// tile, the 8 queries' hi and lo digits stacked into 16 rows.  Here one
// block of 8 warps serves one tile, as the grid branch does, and the dot
// runs on the int8 tensor cores: mma.sync m16n8k32 with the 16 digit rows
// as A and 8 list rows as B (sq_mma.cuh).  The tile's list streams through
// a cp.async ring of 256-row x 128-byte chunks (96 for sq6), each with the
// digits of its dimensions, in shared memory, the next chunks in flight
// while one computes (sq_mma.cuh::ring_scan): each row's bytes of a chunk
// copy in neighbouring 16-byte pieces, so a warp's loads are coalesced.
// The wrapper plans the stages (ops/ivf_sq_pairs.py::stage_plan): two
// blocks an SM, then the deepest ring (at d = 1536: 3 stages, 103 KB).
// Chunks wholly past the count are written -inf without a copy.  Offsets
// into the codes are 64-bit.
// What bounds it on the H100: the code bytes of each tile's list (read
// once a tile, 8 queries a read).  The MMAs (2 int8 operations a digit of
// every (query, row) pair, a twentieth of the bytes' time at the MS MARCO
// shape) and the fragment loads from shared memory stay below it; what
// keeps the copies from the bound is the ring's depth (one chunk in flight
// a block) and the tiles a wave leaves unfinished.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sq_mma.cuh"

namespace {

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(sqm::kThreads, 2)
    ivf_sq_pairs_kernel(sqm::RingArgs a, float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  sqm::ring_scan<CODEC, VEC, L2>(a, out, reinterpret_cast<uint8_t*>(smem4));
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch(const sqm::RingArgs& a, float* out, int smem, int* plan,
                   cudaStream_t stream) {
  auto kernel = ivf_sq_pairs_kernel<CODEC, VEC, L2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, sqm::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (blocks == 0) return cudaErrorInvalidValue;
  if (plan != nullptr) plan[0] = blocks;
  kernel<<<a.t_max, sqm::kThreads, smem, stream>>>(a, out);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t dispatch(bool vec, bool l2, const sqm::RingArgs& a, float* out, int smem,
                     int* plan, cudaStream_t s) {
  const size_t need =
      sqm::kHeadBytes + static_cast<size_t>(a.stages) *
                            (vec ? sqm::Ring<CODEC, true>::kStageBytes
                                 : sqm::Ring<CODEC, false>::kStageBytes);
  if (static_cast<size_t>(smem) < need) return cudaErrorInvalidValue;
  if (vec)
    return l2 ? launch<CODEC, true, true>(a, out, smem, plan, s)
              : launch<CODEC, true, false>(a, out, smem, plan, s);
  return l2 ? launch<CODEC, false, true>(a, out, smem, plan, s)
            : launch<CODEC, false, false>(a, out, smem, plan, s);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for an unknown codec, a chunk width or a shared
// memory size that does not match the kernel's, or a plan no block fits.
// codec: 0 sq8, 1 sq4, 2 sq6.  The caller sizes out as (t_max, 8, lmax)
// and passes lmax a multiple of 4, 8-byte aligned rn and rs, a 4-byte
// aligned mask, 16-byte aligned qs, vec = 1 only with w a multiple of the
// unit (16 bytes; 48 for sq6) and 16-byte aligned codes, dvec = 1 only with width a multiple of 16 and
// 16-byte aligned digits; chunk (code bytes a row per chunk), stages and
// smem from the stage plan.  plan (1 int, or null) receives the blocks an
// SM holds.
extern "C" int dfx_ivf_sq_pairs(const uint8_t* codes, const float* rn, const float* rs,
                                const int* counts, const int8_t* digits, const float* qs,
                                const int* meta, const int8_t* mask, int t_max, int nlist,
                                int lmax, int w, int codec, int l2, int vec, int dvec,
                                int width, int chunk, int stages, int smem, float* out,
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
  a.next_tile = nullptr;
  if (stages < 2 || stages > sqm::kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (codec) {
    case sqd::kSQ8:
      if (chunk == sqm::Geo<sqd::kSQ8>::kCW)
        err = dispatch<sqd::kSQ8>(vec, l2, a, out, smem, plan, s);
      break;
    case sqd::kSQ4:
      if (chunk == sqm::Geo<sqd::kSQ4>::kCW)
        err = dispatch<sqd::kSQ4>(vec, l2, a, out, smem, plan, s);
      break;
    case sqd::kSQ6:
      if (chunk == sqm::Geo<sqd::kSQ6>::kCW)
        err = dispatch<sqd::kSQ6>(vec, l2, a, out, smem, plan, s);
      break;
  }
  return static_cast<int>(err);
}
