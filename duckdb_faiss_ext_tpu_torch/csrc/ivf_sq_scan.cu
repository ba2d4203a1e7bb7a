// Per-query IVF,SQ8/SQ4/SQ6 int8 list search (K2), for Hopper (sm_90a).
// Replaces the TPU kernel duckdb_faiss_ext_tpu/ops/pallas_ivf.py::
// _sq_scan_kernel and what its caller pallas_ivf_sq_search ran around it
// (the top-k_scan, sq_exact_rerank and the resolve); the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_sq_scan.py.
//
// Contract: codes (nlist, lmax, w) uint8 packed rows padded per list,
// rn / rs (nlist, lmax) fp32 per-slot sum (scale c)^2 and sum c, counts
// (nlist,), row_pos (nlist, lmax), probe_ids (nq, nprobe), digits (nq, 2,
// 4 * words) int8 (each query's hi and lo digits in dimension order, zero
// past its codes), qs (nq, 4) fp32 per-query (su2, c0, base, mu), xq (nq,
// d), vmin / scale (d,), optional mask (nlist, lmax) bytes.  A live slot r
// < counts[l] (mask byte not 0) of a probed list l has the int8 score
// sq_digits.cuh::score of the exact digit dots of row r.
//
// Two designs, one source.
// * The fused search (dfx_ivf_sq_topk, k_scan <= 1024): for each query the
//   k_scan best rows by (int8 score desc, flat index asc), flat index =
//   probe slot * lmax + slot, equal bit for bit to the plain exact_topk of
//   the raw scores (the int32 dots are exact and the epilogue is unfused);
//   then their exact fp32 scores, and the k best of those by (fp32 score
//   desc, int8 rank asc), as ops/ivf_sq_scan.py::sq_exact_rerank orders
//   them; missing slots (-inf, -1).  The skeleton is list_topk.cuh: (a) a
//   partial launch over queries x splits (equal shares of a query's row
//   chunks) streams each probed list's live code rows through a ring of
//   shared-memory stages (TMA bulk copies fed by a producer warp) to four
//   consumer warps, each keeping its best k_scan, merged into a block's
//   list; (b) a merge launch, a block a query,
//   merges the splits' lists into the k_scan candidates (written out as
//   well), rescores each on one thread: the row decoded from the padded
//   codes with K5's decode (sq_digits.cuh) and scored in fp32 in dimension
//   order (IP x . q, L2 -sum (x - q)^2), then sorts and resolves.  No score
//   block is written and sq_exact_rerank leaves the card path.  The row
//   score (SqScore): 8 lanes a row, four rows a pass (a unit is a 16-byte
//   VEC unit, 48 bytes for sq6, or a group of four codes; a lane takes
//   every 8th unit of its row), a lane's first units dotted against digit
//   words it keeps in registers, the rest against the digits in shared
//   memory, with __dp4a (sq_digits.cuh), then list_topk.cuh::
//   reduce_scatter over the int32 sums.  At d = 1536 a chunk's 8 rows
//   take 2 passes and 7 shuffle steps a sum this way, where 32 lanes a row
//   would take 8 passes and 31.
// * The raw launch (dfx_ivf_sq_scan): out[i, j, r] for every slot r < lmax
//   of every (query i, probe slot j), -inf where r >= counts[l] or mask[l,
//   r] == 0; one block of 256 threads a (query, probed list) pair, a warp a
//   row, its lanes striding along the row in 16-byte units (48 for sq6)
//   unpacked in registers.  The search takes it, with torch's top-k_scan and
//   sq_exact_rerank, above the fused search's k_scan limit, and it is the
//   in-tree "before" the fused search is timed against.
// Offsets into the codes are 64-bit.
//
// What bounds it on the H100: the code bytes of the probed lists, each read
// once (count x (w + 8) a distinct probed list with rn / rs); the raw
// launch also writes the (nq, nprobe, lmax) score block.  The per-query
// form reads a list once for each query that probes it, which at b48 over
// 4096 lists is nearly once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "list_topk.cuh"
#include "sq_digits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(kThreads)
ivf_sq_scan_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ rn,
                   const float* __restrict__ rs, const int* __restrict__ counts,
                   const int* __restrict__ probe_ids, const int8_t* __restrict__ digits,
                   const float* __restrict__ qs, const int8_t* __restrict__ mask, int nq,
                   int nprobe, int nlist, int lmax, int w, float* __restrict__ out) {
  extern __shared__ int4 dig_s4[];
  int* dig = reinterpret_cast<int*>(dig_s4);
  const int64_t pair = blockIdx.x;  // query * nprobe + probe slot
  const int qi = static_cast<int>(pair / nprobe);
  const int lid = probe_ids[pair];
  float* o = out + pair * lmax;
  const bool live = lid >= 0 && lid < nlist;
  const int cnt = live ? min(max(counts[lid], 0), lmax) : 0;
  for (int r = cnt + threadIdx.x; r < lmax; r += kThreads) o[r] = -INFINITY;
  if (cnt == 0) return;  // block-uniform
  const int words = sqd::digit_words<CODEC>(w);
  sqd::stage_digits(digits, qi, nq, 1, words, dig);
  __syncthreads();

  const float su2 = qs[qi * 4], c0 = qs[qi * 4 + 1], base = qs[qi * 4 + 2],
              mu = qs[qi * 4 + 3];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t slot0 = static_cast<int64_t>(lid) * lmax;
  for (int r = warp; r < cnt; r += kWarps) {
    if (mask && mask[slot0 + r] == 0) {  // warp-uniform: the warp owns row r
      if (lane == 0) o[r] = -INFINITY;
      continue;
    }
    int acc[2] = {0, 0};
    sqd::row_dot<CODEC, VEC, 2>(codes + (slot0 + r) * w, w, lane, 32, dig, acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[0] += __shfl_xor_sync(kFull, acc[0], off);
      acc[1] += __shfl_xor_sync(kFull, acc[1], off);
    }
    if (lane == 0)
      o[r] = sqd::score<L2>(acc[0], acc[1], su2, c0, base, mu, rs[slot0 + r],
                            L2 ? rn[slot0 + r] : 0.f);
  }
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch(const uint8_t* codes, const float* rn, const float* rs, const int* counts,
                   const int* probe_ids, const int8_t* digits, const float* qs,
                   const int8_t* mask, int nq, int nprobe, int nlist, int lmax, int w,
                   float* out, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(sqd::digit_words<CODEC>(w));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_sq_scan_kernel<CODEC, VEC, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(nq) * nprobe);
  ivf_sq_scan_kernel<CODEC, VEC, L2><<<blocks, kThreads, smem, stream>>>(
      codes, rn, rs, counts, probe_ids, digits, qs, mask, nq, nprobe, nlist, lmax, w, out);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t dispatch(bool vec, bool l2, const uint8_t* codes, const float* rn,
                     const float* rs, const int* counts, const int* probe_ids,
                     const int8_t* digits, const float* qs, const int8_t* mask, int nq,
                     int nprobe, int nlist, int lmax, int w, float* out, cudaStream_t s) {
  if (vec)
    return l2 ? launch<CODEC, true, true>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                          nq, nprobe, nlist, lmax, w, out, s)
              : launch<CODEC, true, false>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                           nq, nprobe, nlist, lmax, w, out, s);
  return l2 ? launch<CODEC, false, true>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                         nq, nprobe, nlist, lmax, w, out, s)
            : launch<CODEC, false, false>(codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                          nq, nprobe, nlist, lmax, w, out, s);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or cudaErrorInvalidValue
// for an unknown codec.  codec: 0 sq8, 1 sq4, 2 sq6.  The caller sizes out as
// (nq, nprobe, lmax), keeps nq * nprobe below 2^31, and passes vec = 1 only
// with w a multiple of the unit (16 bytes; 48 for sq6) and 16-byte aligned
// codes; digits must be 4-byte aligned.
extern "C" int dfx_ivf_sq_scan(const uint8_t* codes, const float* rn, const float* rs,
                               const int* counts, const int* probe_ids, const int8_t* digits,
                               const float* qs, const int8_t* mask, int nq, int nprobe,
                               int nlist, int lmax, int w, int codec, int l2, int vec,
                               float* out, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      err = dispatch<sqd::kSQ8>(vec, l2, codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                nq, nprobe, nlist, lmax, w, out, s);
      break;
    case sqd::kSQ4:
      err = dispatch<sqd::kSQ4>(vec, l2, codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                nq, nprobe, nlist, lmax, w, out, s);
      break;
    case sqd::kSQ6:
      err = dispatch<sqd::kSQ6>(vec, l2, codes, rn, rs, counts, probe_ids, digits, qs, mask,
                                nq, nprobe, nlist, lmax, w, out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// --- the fused search ----------------------------------------------------------

namespace {

// The row score of the fused search: L lanes a row, units along the row,
// int32 digit dots, K4's fp32 epilogue.
template <int CODEC, bool VEC, bool L2>
struct SqScore {
  using U = sqd::Unpack<CODEC>;
  static constexpr int L = 8;                                // lanes a row
  static constexpr int R = 32 / L;                           // rows a pass
  static constexpr int WU = VEC ? U::kVecWords : 1;          // digit words a unit
  static constexpr int UB = VEC ? U::kVecBytes : U::kGroupBytes;  // code bytes a unit
  // units whose digits a lane keeps in registers: 24-32 ints
  static constexpr int JR = !VEC ? 4 : CODEC == sqd::kSQ8 ? 3 : CODEC == sqd::kSQ4 ? 2 : 1;
  const int* dig;  // [word][hi, lo] in shared memory
  const float* rs;
  const float* rn;
  int units, w;
  float su2, c0, base, mu;
  int dr[JR][WU][2];

  __device__ SqScore(const int* dig_s, const float* qs, const float* rs_, const float* rn_,
                     int w_, int lane)
      : dig(dig_s), rs(rs_), rn(rn_), units(VEC ? w_ / UB : U::groups(w_)), w(w_),
        su2(qs[0]), c0(qs[1]), base(qs[2]), mu(qs[3]) {
#pragma unroll
    for (int i = 0; i < JR; ++i) {
      const int u = lane % L + i * L;
#pragma unroll
      for (int k = 0; k < WU; ++k) {
        const int word = u * WU + k;
        dr[i][k][0] = u < units ? dig[2 * word] : 0;
        dr[i][k][1] = u < units ? dig[2 * word + 1] : 0;
      }
    }
  }

  // The code words of unit u of a staged row.
  __device__ __forceinline__ void unit_words(const uint8_t* x, int u, int (&words)[WU]) const {
    if constexpr (VEC) {
      const uint4* p4 = reinterpret_cast<const uint4*>(x + u * UB);
      uint4 v[U::kVecUnits];
#pragma unroll
      for (int i = 0; i < U::kVecUnits; ++i) v[i] = p4[i];
      U::from_units(v, words);
    } else {
      words[0] = U::group_at(x + u * UB, w - u * UB);
    }
  }

  __device__ float score_chunk(const uint8_t* st, int n, int64_t slot0, int lane,
                               int& row) const {
    const int t = lane % L, g = lane / L;
    int hi[L], lo[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      hi[j] = lo[j] = 0;
      const int r = j * R + g;
      if (r < n) {
        const uint8_t* x = st + r * w;
        int h = 0, l = 0;
        int words[WU];
#pragma unroll
        for (int i = 0; i < JR; ++i) {
          const int u = t + i * L;
          if (u < units) {
            unit_words(x, u, words);
#pragma unroll
            for (int k = 0; k < WU; ++k) {
              h = __dp4a(words[k], dr[i][k][0], h);
              l = __dp4a(words[k], dr[i][k][1], l);
            }
          }
        }
        for (int u = t + JR * L; u < units; u += L) {
          unit_words(x, u, words);
#pragma unroll
          for (int k = 0; k < WU; ++k) {
            const int word = u * WU + k;
            h = __dp4a(words[k], dig[2 * word], h);
            l = __dp4a(words[k], dig[2 * word + 1], l);
          }
        }
        hi[j] = h;
        lo[j] = l;
      }
    }
    ltk::reduce_scatter<L>(hi, lane);
    ltk::reduce_scatter<L>(lo, lane);
    row = ltk::scattered_row<L>(lane);
    if (row >= n) return -INFINITY;
    return sqd::score<L2>(hi[0], lo[0], su2, c0, base, mu, rs[slot0 + row],
                          L2 ? rn[slot0 + row] : 0.f);
  }
};

constexpr int kMaxWarps = 8;  // consumer warps a partial block at most

template <int CODEC, bool VEC, bool L2>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1))
ivf_sq_topk_partial(const ltk::Plan p, const uint8_t* __restrict__ codes,
                    const float* __restrict__ rn, const float* __restrict__ rs,
                    const int* __restrict__ counts, const int* __restrict__ probe_ids,
                    const int8_t* __restrict__ digits, const float* __restrict__ qs,
                    const int8_t* __restrict__ mask, float* __restrict__ part_s,
                    int* __restrict__ part_p) {
  extern __shared__ __align__(128) unsigned char smem_topk[];
  int* dig = reinterpret_cast<int*>(smem_topk + ((ltk::partial_head_bytes(p) + 15) & ~15));
  const int q = blockIdx.x;
  sqd::stage_digits(digits, q, p.nq, 1, sqd::digit_words<CODEC>(p.row_bytes), dig);
  __syncthreads();
  const SqScore<CODEC, VEC, L2> score(dig, qs + 4 * static_cast<int64_t>(q), rs, rn,
                                         p.row_bytes, threadIdx.x & 31);
  ltk::partial(score, smem_topk, p, codes, counts, probe_ids, mask, part_s, part_p);
}

// The raw codes (c, not c ^ 0x80) of dimensions 4g .. 4g + 3 of a row, a byte each.
template <int CODEC>
__device__ __forceinline__ uint32_t raw_group(const uint8_t* row, int g, int w) {
  const uint32_t v = static_cast<uint32_t>(sqd::Unpack<CODEC>::group(row, g, w));
  return CODEC == sqd::kSQ8 ? v ^ 0x80808080u : v;
}

// A block a query: its splits' lists merged into the k_scan candidates
// (written to cand_s / cand_p), each rescored in fp32 by one thread, the best
// k by (fp32 score desc, candidate rank asc) resolved.
template <int CODEC, bool L2>
__global__ void __launch_bounds__(256)
ivf_sq_topk_merge(const ltk::Plan p, const uint8_t* __restrict__ codes,
                  const int* __restrict__ row_pos, const int* __restrict__ probe_ids,
                  const float* __restrict__ xq, const float* __restrict__ vmin,
                  const float* __restrict__ scale, int d, const float* __restrict__ part_s,
                  const int* __restrict__ part_p, float* __restrict__ cand_s,
                  int* __restrict__ cand_p, float* __restrict__ out_s, int* __restrict__ out_p) {
  extern __shared__ __align__(16) unsigned char smem_merge[];
  float* s = reinterpret_cast<float*>(smem_merge);
  int* pos = reinterpret_cast<int*>(s + p.merge_slots);
  int* flat_s = pos + p.merge_slots;  // k2: the candidates' flat indices
  float* q_s = reinterpret_cast<float*>(flat_s + p.k2);
  float* sc_s = q_s + d;
  float* vm_s = sc_s + d;
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < d; i += blockDim.x) {
    q_s[i] = xq[static_cast<int64_t>(q) * d + i];
    sc_s[i] = scale[i];
    vm_s[i] = vmin[i];
  }
  if (tid < 32) {
    ltk::TopK top;
    ltk::merge_splits(top, s, pos, p, part_s, part_p, q, lane);
  }
  __syncthreads();
  const int64_t c0 = static_cast<int64_t>(q) * p.k2;
  for (int i = tid; i < p.k2; i += blockDim.x) {
    const int flat = pos[i];
    const float a = s[i];
    cand_s[c0 + i] = a;
    cand_p[c0 + i] = flat == ltk::kNoPos ? -1 : flat;
    float e = -INFINITY;
    if (flat != ltk::kNoPos && a != -INFINITY) {
      const int slot = flat / p.lmax;
      const int lid = probe_ids[static_cast<int64_t>(q) * p.nprobe + slot];
      const uint8_t* row =
          codes + (static_cast<int64_t>(lid) * p.lmax + flat - slot * p.lmax) * p.row_bytes;
      float acc = 0.f;
      for (int g = 0; 4 * g < d; ++g) {
        const uint32_t v = raw_group<CODEC>(row, g, p.row_bytes);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int t = 4 * g + b;
          if (t < d) {
            const float x = sqd::decode((v >> (8 * b)) & 0xFFu, sc_s, vm_s, t);
            if (L2) {
              const float u = x - q_s[t];
              acc = fmaf(u, u, acc);
            } else {
              acc = fmaf(x, q_s[t], acc);
            }
          }
        }
      }
      e = L2 ? -acc : acc;
    }
    flat_s[i] = flat;
    s[i] = e;
    pos[i] = i;  // the candidate's rank: ties keep the int8 order
  }
  __syncthreads();
  if (tid >= 32) return;
  wtk::sort_used(s, pos, p.k2, lane);
  for (int t = lane; t < p.k; t += 32) {
    const float sc = t < p.k2 ? s[t] : -INFINITY;
    const int rank = t < p.k2 ? pos[t] : ltk::kNoPos;
    const int row = sc == -INFINITY || rank == ltk::kNoPos
                        ? -1
                        : ltk::resolve(flat_s[rank], p, probe_ids, row_pos, q);
    out_s[static_cast<int64_t>(q) * p.k + t] = row < 0 ? -INFINITY : sc;
    out_p[static_cast<int64_t>(q) * p.k + t] = row;
  }
}

template <int CODEC, bool VEC, bool L2>
cudaError_t launch_partial(const ltk::Plan& p, const uint8_t* codes, const float* rn,
                           const float* rs, const int* counts, const int* probe_ids,
                           const int8_t* digits, const float* qs, const int8_t* mask,
                           float* part_s, int* part_p, cudaStream_t stream) {
  const auto kernel = ivf_sq_topk_partial<CODEC, VEC, L2>;
  const cudaError_t err = ltk::set_smem(reinterpret_cast<const void*>(kernel), p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nq, p.splits), 32 * (p.warps + 1), p.smem, stream>>>(
      p, codes, rn, rs, counts, probe_ids, digits, qs, mask, part_s, part_p);
  return cudaGetLastError();
}

template <int CODEC, bool L2>
cudaError_t launch_merge(const ltk::Plan& p, const uint8_t* codes, const int* row_pos,
                         const int* probe_ids, const float* xq, const float* vmin,
                         const float* scale, int d, const float* part_s, const int* part_p,
                         float* cand_s, int* cand_p, float* out_s, int* out_p,
                         cudaStream_t stream) {
  const auto kernel = ivf_sq_topk_merge<CODEC, L2>;
  const cudaError_t err = ltk::set_smem(reinterpret_cast<const void*>(kernel), p.merge_smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.nq, 32 * p.merge_warps, p.merge_smem, stream>>>(
      p, codes, row_pos, probe_ids, xq, vmin, scale, d, part_s, part_p, cand_s, cand_p, out_s,
      out_p);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t launch_codec(const ltk::Plan& p, bool vec, bool l2, int stages,
                         const uint8_t* codes, const float* rn, const float* rs,
                         const int* counts, const int* row_pos, const int* probe_ids,
                         const int8_t* digits, const float* qs, const float* xq,
                         const float* vmin, const float* scale, const int8_t* mask, int d,
                         float* part_s, int* part_p, float* cand_s, int* cand_p, float* out_s,
                         int* out_p, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
#define DFX_PARTIAL(V, L2)                                                                \
  launch_partial<CODEC, V, L2>(p, codes, rn, rs, counts, probe_ids, digits, qs, mask, part_s, \
                               part_p, stream)
    if (vec)
      err = l2 ? DFX_PARTIAL(true, true) : DFX_PARTIAL(true, false);
    else
      err = l2 ? DFX_PARTIAL(false, true) : DFX_PARTIAL(false, false);
#undef DFX_PARTIAL
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    err = l2 ? launch_merge<CODEC, true>(p, codes, row_pos, probe_ids, xq, vmin, scale, d,
                                          part_s, part_p, cand_s, cand_p, out_s, out_p, stream)
             : launch_merge<CODEC, false>(p, codes, row_pos, probe_ids, xq, vmin, scale, d,
                                           part_s, part_p, cand_s, cand_p, out_s, out_p, stream);
  }
  return err;
}

}  // namespace

// The fused search: runs the launches named by `stages` (1 the partial, 2
// the merge) on `stream`; returns the CUDA error of the first that fails (0
// on success), cudaErrorInvalidValue for a codec or shape it does not take.
// plan: ltk::kPlanInts ints (ops/ivf_sq_scan.py::plan) with row_bytes = w,
// k2 = k_scan <= 1024, warps <= 8, merge_warps <= 8, the smem sizes cover
// list_topk.cuh's layout plus the digits (partial) and merge_slots pairs,
// k2 flat indices and 3 d floats (merge); codec 0 sq8, 1 sq4, 2 sq6;
// vec = 1 only with w a multiple of the VEC unit (16 bytes; 48
// for sq6) and 16-byte aligned codes; tma = 1 only with the codes' first
// and last byte on 16-byte boundaries; digits 4-byte aligned.  part_s /
// part_p (nq, splits, k_scan), cand_s / cand_p (nq, k_scan), out_s / out_p
// (nq, k).
extern "C" int dfx_ivf_sq_topk(const uint8_t* codes, const float* rn, const float* rs,
                               const int* counts, const int* row_pos, const int* probe_ids,
                               const int8_t* digits, const float* qs, const float* xq,
                               const float* vmin, const float* scale, const int8_t* mask,
                               const int* plan, int d, int codec, int l2, int vec,
                               float* part_s, int* part_p, float* cand_s, int* cand_p,
                               float* out_s, int* out_p, int stages, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const ltk::Plan p = ltk::plan_from(plan);
  if (p.warps < 1 || p.warps > kMaxWarps || p.merge_warps < 1 || p.merge_warps > 8 ||
      p.stages % p.warps != 0 || p.stages < p.warps || p.chunk_rows < 1 ||
      p.chunk_rows > ltk::kChunkRows)
    return static_cast<int>(cudaErrorInvalidValue);
#define DFX_CODEC(C)                                                                          \
  launch_codec<C>(p, vec != 0, l2 != 0, stages, codes, rn, rs, counts, row_pos,               \
                  probe_ids, digits, qs, xq, vmin, scale, mask, d, part_s, part_p, cand_s,    \
                  cand_p, out_s, out_p, s)
  cudaError_t err;
  switch (codec) {
    case sqd::kSQ8:
      err = DFX_CODEC(sqd::kSQ8);
      break;
    case sqd::kSQ4:
      err = DFX_CODEC(sqd::kSQ4);
      break;
    case sqd::kSQ6:
      err = DFX_CODEC(sqd::kSQ6);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef DFX_CODEC
  return static_cast<int>(err);
}
