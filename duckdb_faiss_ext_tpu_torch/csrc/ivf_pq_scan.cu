// IVF-PQ / IVF-RQ list search (K8), for Hopper (sm_90a): each query's
// probed lists scored by table lookups (LUT-ADC), the top-k fused in, and
// an exact fp32 rescore of the candidates.  Replaces the TPU kernel
// duckdb_faiss_ext_tpu/ops/pallas_ivf.py::_gather_kernel (wrapper
// pallas_gather_lists) with what its caller pallas_ivf_pq_search left to
// XLA (decode, score, top-k, position resolve); the Python wrapper is
// duckdb_faiss_ext_tpu_torch/ops/ivf_pq_scan.py::ivf_pq_list_search.
//
// Contract: lists (nlist, lmax, m) uint8 byte codes padded per list, counts
// (nlist,), row_pos (nlist, lmax) storage rows, probe_ids (nq, nprobe), xq
// (nq, d), centroids (nlist, d), codebooks (m, ksub, dsub) for PQ
// (m * dsub == d) or (m, ksub, d) for RQ, an optional mask (nlist, lmax) of
// bytes, and for L2 the row terms rt (nlist, lmax) (below).  A live slot
// r < counts[l] (with a non-zero mask byte) of a probed list l is the row
// x = dec(code) + centroid[l], decoded by residual:
//   PQ: dec_t = cb[t / dsub][code[t / dsub]][t % dsub]
//   RQ: dec_t = sum_s cb[s][code_s][t], summed in stage order s = 0 .. m-1
// and scores  IP: x . q   L2: -sum_t (x_t - q_t)^2  (difference form).  For
// each query: the k best (score, storage row), sorted by score descending,
// then by flat index (probe slot * lmax + slot) ascending; missing slots
// are (-inf, -1).  The returned scores are fp32 FMA sums in dimension order.
//
// What bounds it on the H100.  The bytes the function must move are small
// (at b1024, nprobe 64 over IVF4096,PQ16 1M x 128: the distinct probed
// lists' codes, 16 MB, their row terms and centroids, the codebooks, the
// queries: some 0.01 ms at 3.35 TB/s), and so are its fp32 operations (the
// table build, M + 2 adds a probed row, the rescore).  What sets the
// practical floor is the shared-memory table lookups: 13.9M probed rows x M
// (222M at PQ16 b1024), 32 lanes at random entries of one 1 KB stage table,
// about three-way bank conflicts.  The TPU kernel's design (gather the code
// blocks, decode to fp32 rows, score, then a top-k over a (nq, nprobe,
// lmax) score block) would move 403 MB of scores at b1024 before the
// top-k reads them back; here neither the decoded rows nor the score block
// reach device memory.
//
// Design: three launches.
//   (a) pq_lut_kernel: the query's distance table lut[q, s, j] in fp32,
//       PQ: sum over t of subspace s of q_t * cb[s][j][t - s*dsub];
//       RQ: <q, cb[s][j]> over all d; each sum in dimension order.  A block
//       takes 32 queries x 64 entries of one stage through 32-dim chunks in
//       shared memory, so each codebook entry is read once a query tile (the
//       RQ8x8 codebook is 1 MB at d = 128).  The blocks of the first query
//       tile also write their entries' largest squared norm (cbn, for the
//       error bound).
//   (b) ivf_pq_topk_partial: grid = queries x probe splits.  A block stages
//       its query's table in shared memory (or, when M x ksub x 4 B passes
//       the budget, reads it from (a)'s output through L1 / L2: a template
//       switch), takes base of each of its probed lists in difference form,
//       in dimension order (L2 |q - c|^2, IP <q, c>), then its warps walk
//       32-row chunks of the lists, chunk g of the block to warp g % warps,
//       one lane a row: the row's M code bytes in vector loads (neighbouring
//       lanes on neighbouring rows), its row term and mask byte, and M
//       table lookups summed in stage order,
//         L2: score = -((base + rt[l, r]) - 2 sum_s lut[q, s, code_s])
//         IP: score = base + sum_s lut[q, s, code_s].
//       Rows at or past the count are never read.  Each warp keeps the best
//       K2 = k + m rows by that score, then flat index, with K1's threshold
//       / append / bitonic sort (warp_topk.cuh); warp 0 then merges the
//       other warps' lists into its own, and the block writes one sorted
//       list of K2 and its lists' largest |c|^2: a query has `splits`.
//   (c) ivf_pq_topk_merge: a warp per query merges its splits' lists into
//       the best K2, rescores each candidate exactly with the plain
//       version's formula (the row decoded, PQ by gather, RQ by the stage
//       sum in stage order, plus the centroid; IP x . q or L2 -sum (x - q)^2
//       in dimension order, fp32 FMA, a lane a candidate), sorts by (exact
//       score desc, flat index asc), resolves positions through row_pos, and
//       writes k.
// The row term rt[l, r] = |res|^2 + 2 <c_l, res> of every live slot (res
// the decoded residual) is built once per layout (models/ivf_layout.py):
// RQ's stages are not orthogonal, so |res|^2 has cross terms no per-code
// table holds.  IP needs none.
//
// Choice of m.  With u = 2^-24, gamma^2 the largest |c|^2 over the query's
// probed centroids, rho a bound on |res| from the codebooks (PQ:
// sqrt(sum_s max_j |cb_s[j]|^2); RQ: sum_s max_j |cb_s[j]|, which also
// bounds the stage sum's terms) and T = (|q| + gamma + rho)^2, the fp32
// table score and the plain version's fp32 difference form of one row
// differ by at most E:
//   L2: base (d + 2 roundings of terms at most (|q| + gamma)^2), rt (d + 2
//     of terms at most rho^2 + 2 gamma rho), the table sum (dsub or d
//     roundings in each entry, then M adds, of terms at most |q| rho), the
//     epilogue's three adds, and the plain version's own sum (d + 2) and
//     decode (x_t rounded once for PQ, M + 1 times for RQ), every term at
//     most T:  E = (4d + 2M + 16) u T;
//   IP: the same pieces without the squares:  E = (2d + 2M + 8) u |q| (gamma
//     + rho).
// A row outside the final K2 candidates has a table score at most a_K2 (the
// K2-th candidate's), so an exact score at most a_K2 + E; the k-th exact
// score e_k is proven whenever a_K2 < e_k - 2E (the second E covers the
// rescore's own rounding against the plain version's).  The rows within 2E
// of the k-th score are few, as for K1 (flat_topk.cu), and m = max(16,
// k / 8) leaves that count far behind.  The merge counts the queries where
// a_K2 >= e_k - 2E (unproven; duplicated rows that tie are among them), a
// diagnostic: the result is the same either way.
//
// Codes index the codebook as code & (ksub - 1): codes are below ksub by
// construction, and the mask keeps a damaged code inside the table.  Flat
// indices are int32 (the caller keeps nprobe * lmax below 2^31); offsets
// into the codes, the tables and the outputs are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using wtk::kFull;
using wtk::kNoPos;
using wtk::push_sorted_lists;
using wtk::sort_used;
using wtk::TopK;

constexpr int kThreads = 256;

// --- (a) the distance table ------------------------------------------------

constexpr int kLutQ = 32;            // queries a block
constexpr int kLutE = 64;            // codebook entries a block, of one stage
constexpr int kLutT = 32;            // dims a staged chunk
constexpr int kLutQLD = kLutQ + 4;   // [t][query] stride: 16-byte rows for float4 reads
constexpr int kLutELD = kLutT + 1;   // [entry][t] stride: conflict-free column reads

template <bool RQ>
__global__ void __launch_bounds__(kThreads)
pq_lut_kernel(const float* __restrict__ xq, const float* __restrict__ cb, int nq, int d,
              int m, int ksub, int dsub, float* __restrict__ lut, float* __restrict__ cbn) {
  __shared__ __align__(16) float qs[kLutT * kLutQLD];  // [t][query]
  __shared__ float cs[kLutE * kLutELD];                // [entry][t]
  const int tid = threadIdx.x;
  const int etiles = (ksub + kLutE - 1) / kLutE;
  const int s = blockIdx.y / etiles;
  const int j0 = (blockIdx.y - s * etiles) * kLutE;
  const int q0 = blockIdx.x * kLutQ;
  const int w = RQ ? d : dsub;           // dims of an entry
  const int qoff = RQ ? 0 : s * dsub;    // where the entry's dims start in q
  const int ne = min(kLutE, ksub - j0);
  const float* cbs = cb + (static_cast<int64_t>(s) * ksub + j0) * w;
  // This thread's entry and its eight queries; a warp shares qg, so its
  // query reads are broadcasts.
  const int e = tid % kLutE, qg = tid / kLutE;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float nrm = 0.f;
  for (int c0 = 0; c0 < w; c0 += kLutT) {
    for (int i = tid; i < kLutQ * kLutT; i += kThreads) {
      const int qq = i / kLutT, t = i % kLutT;
      qs[t * kLutQLD + qq] = q0 + qq < nq && c0 + t < w
                                 ? xq[static_cast<int64_t>(q0 + qq) * d + qoff + c0 + t]
                                 : 0.f;
    }
    for (int i = tid; i < kLutE * kLutT; i += kThreads) {
      const int ee = i / kLutT, t = i % kLutT;
      cs[ee * kLutELD + t] =
          ee < ne && c0 + t < w ? cbs[static_cast<int64_t>(ee) * w + c0 + t] : 0.f;
    }
    __syncthreads();
    // Zero-filled dims past w add exact zeros: the sums stay in dimension order.
#pragma unroll 8
    for (int t = 0; t < kLutT; ++t) {
      const float c = cs[e * kLutELD + t];
      const float4 a = *reinterpret_cast<const float4*>(qs + t * kLutQLD + qg * 8);
      const float4 b = *reinterpret_cast<const float4*>(qs + t * kLutQLD + qg * 8 + 4);
      acc[0] = fmaf(a.x, c, acc[0]);
      acc[1] = fmaf(a.y, c, acc[1]);
      acc[2] = fmaf(a.z, c, acc[2]);
      acc[3] = fmaf(a.w, c, acc[3]);
      acc[4] = fmaf(b.x, c, acc[4]);
      acc[5] = fmaf(b.y, c, acc[5]);
      acc[6] = fmaf(b.z, c, acc[6]);
      acc[7] = fmaf(b.w, c, acc[7]);
      nrm = fmaf(c, c, nrm);
    }
    __syncthreads();
  }
  if (e < ne) {
    float* out = lut + static_cast<int64_t>(s) * ksub + j0 + e;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + qg * 8 + i;
      if (q < nq) out[static_cast<int64_t>(q) * m * ksub] = acc[i];
    }
  }
  if (blockIdx.x == 0) {  // block-uniform: the tile's largest |entry|^2, from warps 0 and 1
    __shared__ float wmax[2];
    float v = qg == 0 && e < ne ? nrm : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    if (tid < 64 && (tid & 31) == 0) wmax[tid >> 5] = v;
    __syncthreads();
    if (tid == 0) cbn[blockIdx.y] = fmaxf(wmax[0], wmax[1]);
  }
}

// --- (b) the scan, with candidates -----------------------------------------

// Sum of the row's M table entries in stage order; the row's codes are read
// VEC bytes at a time (VEC divides m, rows VEC-aligned).
template <bool SMEM, int VEC>
__device__ __forceinline__ float table_sum(const uint8_t* __restrict__ row, const float* tab,
                                           int m, int ksub) {
  const int kmask = ksub - 1;
  float acc = 0.f;
  auto word = [&](uint32_t v, int s) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float* e = tab + (s + b) * ksub + ((v >> (8 * b)) & kmask);
      acc += SMEM ? *e : __ldg(e);
    }
  };
  if (VEC == 16) {
    for (int s = 0; s < m; s += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + s));
      word(v.x, s);
      word(v.y, s + 4);
      word(v.z, s + 8);
      word(v.w, s + 12);
    }
  } else if (VEC == 8) {
    for (int s = 0; s < m; s += 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + s));
      word(v.x, s);
      word(v.y, s + 4);
    }
  } else if (VEC == 4) {
    for (int s = 0; s < m; s += 4) word(__ldg(reinterpret_cast<const uint32_t*>(row + s)), s);
  } else {
    for (int s = 0; s < m; ++s) {
      const float* e = tab + s * ksub + (row[s] & kmask);
      acc += SMEM ? *e : __ldg(e);
    }
  }
  return acc;
}

// Shared-memory bytes of ivf_pq_topk_partial: the table when staged, each
// probed list's (base, |c|^2, list id, count), each warp's candidate list.
size_t partial_smem(bool smem_lut, int table, int pps, int warps, int slots) {
  return sizeof(float) * (smem_lut ? static_cast<size_t>(table) : 0) + 16 * static_cast<size_t>(pps) +
         8 * static_cast<size_t>(warps) * slots;
}

template <bool L2, bool SMEM, int VEC>
__global__ void __launch_bounds__(kThreads)
ivf_pq_topk_partial(const uint8_t* __restrict__ lists, const int* __restrict__ counts,
                    const float* __restrict__ rt, const int* __restrict__ probe_ids,
                    const float* __restrict__ xq, const float* __restrict__ centroids,
                    const int8_t* __restrict__ mask, const float* __restrict__ lut, int nprobe,
                    int nlist, int lmax, int m, int d, int ksub, int pps, int k2, int slots,
                    int vec4, float* __restrict__ part_s, int* __restrict__ part_p,
                    float* __restrict__ cmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int table = m * ksub;
  float* lut_s = reinterpret_cast<float*>(smem);
  float* base_s = lut_s + (SMEM ? table : 0);
  float* cn_s = base_s + pps;
  int* lid_s = reinterpret_cast<int*>(cn_s + pps);
  int* cnt_s = lid_s + pps;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* lists_s = reinterpret_cast<float*>(cnt_s + pps);  // warp w's list at 2 w slots
  float* top_s = lists_s + 2 * warp * slots;
  int* top_p = reinterpret_cast<int*>(top_s + slots);

  const int q = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int p0 = split * pps;
  const int np = min(pps, nprobe - p0);
  const float* lq = lut + static_cast<int64_t>(q) * table;
  if (SMEM) {
    if ((table & 3) == 0) {
      for (int i = tid; i < table / 4; i += blockDim.x)
        reinterpret_cast<float4*>(lut_s)[i] = __ldg(reinterpret_cast<const float4*>(lq) + i);
    } else {
      for (int i = tid; i < table; i += blockDim.x) lut_s[i] = __ldg(lq + i);
    }
  }
  // A thread a probed list: base and |c|^2, each in dimension order.
  const float* qrow = xq + static_cast<int64_t>(q) * d;
  for (int i = tid; i < np; i += blockDim.x) {
    const int lid = probe_ids[static_cast<int64_t>(q) * nprobe + p0 + i];
    int cnt = 0;
    float base = 0.f, cn = 0.f;
    if (lid >= 0 && lid < nlist) {
      cnt = min(max(counts[lid], 0), lmax);
      const float* c = centroids + static_cast<int64_t>(lid) * d;
      auto step = [&](float qv, float cv) {
        if (L2) {
          const float u = qv - cv;
          base = fmaf(u, u, base);
        } else {
          base = fmaf(qv, cv, base);
        }
        cn = fmaf(cv, cv, cn);
      };
      if (vec4) {
        // Unrolled, so that several of the centroid's loads are in flight.
#pragma unroll 8
        for (int t = 0; t < d; t += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + t);
          const float4 b = __ldg(reinterpret_cast<const float4*>(c + t));
          step(a.x, b.x);
          step(a.y, b.y);
          step(a.z, b.z);
          step(a.w, b.w);
        }
      } else {
#pragma unroll 8
        for (int t = 0; t < d; ++t) step(qrow[t], __ldg(c + t));
      }
    }
    base_s[i] = base;
    cn_s[i] = cn;
    lid_s[i] = lid;
    cnt_s[i] = cnt;
  }
  __syncthreads();
  if (warp == 0) {  // the largest |c|^2 over the block's probed lists
    float v = 0.f;
    for (int i = lane; i < np; i += 32) v = fmaxf(v, cn_s[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    if (lane == 0) cmax[static_cast<int64_t>(q) * splits + split] = v;
  }

  const float* tab = SMEM ? lut_s : lq;
  TopK top;
  top.init(top_s, top_p, k2, slots, lane);
  int items = 0;  // 32-row chunks of the block's lists before list i
  for (int i = 0; i < np; ++i) {
    const int cnt = cnt_s[i];
    if (cnt == 0) continue;
    const int nch = (cnt + 31) >> 5;
    const int lid = lid_s[i];
    const float base = base_s[i];
    const uint8_t* codes = lists + static_cast<int64_t>(lid) * lmax * m;
    const float* rtl = L2 ? rt + static_cast<int64_t>(lid) * lmax : nullptr;
    const int8_t* ml = mask ? mask + static_cast<int64_t>(lid) * lmax : nullptr;
    const int flat0 = (p0 + i) * lmax;
    for (int c = ((warp - items) % warps + warps) % warps; c < nch; c += warps) {
      const int r = c * 32 + lane;
      const bool valid = r < cnt && (ml == nullptr || ml[r] != 0);
      float sc = -INFINITY;
      if (valid) {
        const float acc = table_sum<SMEM, VEC>(codes + static_cast<int64_t>(r) * m, tab, m, ksub);
        sc = L2 ? -((base + rtl[r]) - 2.f * acc) : base + acc;
      }
      top.push(valid, sc, flat0 + r, lane);  // warp-uniform: every lane calls
    }
    items += nch;
  }
  if (top.cnt > 0) top.flush(lane);
  // Warp 0 merges the other warps' sorted lists into its own.
  __syncthreads();
  if (warp != 0) return;
  push_sorted_lists(top, lists_s + 2 * slots, reinterpret_cast<const int*>(lists_s + 3 * slots),
                    warps - 1, lane, 2 * slots);
  if (top.cnt > 0) top.flush(lane);
  const int64_t out = (static_cast<int64_t>(q) * splits + split) * k2;
  for (int t = lane; t < k2; t += 32) {
    part_s[out + t] = top_s[t];
    part_p[out + t] = top_p[t];
  }
}

// --- (c) merge and exact rescore -------------------------------------------

// The bound E of the source note for one query.
__device__ __forceinline__ float error_bound(float qn, float cn, float rho, int d, int m, bool l2) {
  const float u = 5.9604645e-8f;  // 2^-24
  const float qa = sqrtf(qn), ca = sqrtf(cn);
  if (l2) {
    const float r = qa + ca + rho;
    return (4.f * d + 2.f * m + 16.f) * u * r * r * 1.001f;
  }
  return (2.f * d + 2.f * m + 8.f) * u * qa * (ca + rho) * 1.001f;
}

template <bool L2>
__device__ __forceinline__ float exact_term(float x, float qv, float acc) {
  if (L2) {
    const float u = x - qv;
    return fmaf(u, u, acc);
  }
  return fmaf(x, qv, acc);
}

template <bool RQ, bool L2>
__global__ void __launch_bounds__(kThreads)
ivf_pq_topk_merge(const uint8_t* __restrict__ lists, const int* __restrict__ row_pos,
                  const int* __restrict__ probe_ids, const float* __restrict__ xq,
                  const float* __restrict__ centroids, const float* __restrict__ codebooks,
                  const float* __restrict__ part_s, const int* __restrict__ part_p,
                  const float* __restrict__ cmax, const float* __restrict__ cbn, int nq,
                  int nprobe, int lmax, int m, int d, int ksub, int dsub, int splits, int k,
                  int k2, int slots, float* __restrict__ out_s, int* __restrict__ out_p,
                  int* __restrict__ unproven) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * warps + warp;
  if (q >= nq) return;  // warp-uniform; this kernel has no block barrier
  float* s = reinterpret_cast<float*>(smem) + warp * slots;
  int* p = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + warps * slots) + warp * slots;
  TopK top;
  top.init(s, p, k2, slots, lane);
  push_sorted_lists(top, part_s + static_cast<int64_t>(q) * splits * k2,
                    part_p + static_cast<int64_t>(q) * splits * k2, splits, lane, k2);
  if (top.cnt > 0) top.flush(lane);
  const float a_last = s[k2 - 1];
  const bool full = p[k2 - 1] != kNoPos;

  // For the bound: |q|^2, the largest |c|^2 over the probed lists, rho.
  const float* qrow = xq + static_cast<int64_t>(q) * d;
  const int etiles = (ksub + kLutE - 1) / kLutE;
  float qn = 0.f, cn = 0.f, rho = 0.f;
  for (int t = lane; t < d; t += 32) qn = fmaf(qrow[t], qrow[t], qn);
  for (int sp = lane; sp < splits; sp += 32) cn = fmaxf(cn, cmax[static_cast<int64_t>(q) * splits + sp]);
  for (int st = lane; st < m; st += 32) {
    float e = 0.f;
    for (int j = 0; j < etiles; ++j) e = fmaxf(e, cbn[st * etiles + j]);
    rho += RQ ? sqrtf(e) : e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qn += __shfl_xor_sync(kFull, qn, off);
    cn = fmaxf(cn, __shfl_xor_sync(kFull, cn, off));
    rho += __shfl_xor_sync(kFull, rho, off);
  }
  if (!RQ) rho = sqrtf(rho);

  // Exact fp32 rescore of the K2 candidates, a lane a candidate.
  const int kmask = ksub - 1;
  __syncwarp();
  for (int i = lane; i < k2; i += 32) {
    const int pos = p[i];
    if (pos == kNoPos) continue;
    const int slot = pos / lmax, r = pos - slot * lmax;
    const int lid = probe_ids[static_cast<int64_t>(q) * nprobe + slot];
    const uint8_t* row = lists + (static_cast<int64_t>(lid) * lmax + r) * m;
    const float* c = centroids + static_cast<int64_t>(lid) * d;
    float acc = 0.f;
    if (RQ) {
      for (int t = 0; t < d; ++t) {
        float dec = 0.f;
        for (int st = 0; st < m; ++st)
          dec += __ldg(codebooks + (static_cast<int64_t>(st) * ksub + (row[st] & kmask)) * d + t);
        acc = exact_term<L2>(dec + c[t], qrow[t], acc);
      }
    } else {
      for (int st = 0; st < m; ++st) {
        const float* e = codebooks + (static_cast<int64_t>(st) * ksub + (row[st] & kmask)) * dsub;
        for (int u = 0; u < dsub; ++u) {
          const int t = st * dsub + u;
          acc = exact_term<L2>(__ldg(e + u) + c[t], qrow[t], acc);
        }
      }
    }
    s[i] = L2 ? -acc : acc;
  }
  __syncwarp();
  sort_used(s, p, k2, lane);
  for (int t = lane; t < k; t += 32) {
    const float sc = s[t];
    const int pos = p[t];
    int row = -1;
    if (pos != kNoPos && sc != -INFINITY) {
      const int slot = pos / lmax;
      const int lid = probe_ids[static_cast<int64_t>(q) * nprobe + slot];
      row = row_pos[static_cast<int64_t>(lid) * lmax + pos - slot * lmax];
    }
    out_s[static_cast<int64_t>(q) * k + t] = row < 0 ? -INFINITY : sc;
    out_p[static_cast<int64_t>(q) * k + t] = row;
  }
  const float e_k = s[k - 1];
  if (lane == 0 && full && e_k > -INFINITY &&
      a_last >= e_k - 2.f * error_bound(qn, cn, rho, d, m, L2))
    atomicAdd(unproven, 1);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool L2, bool SMEM, int VEC>
cudaError_t launch_partial(const uint8_t* lists, const int* counts, const float* rt,
                           const int* probe_ids, const float* xq, const float* centroids,
                           const int8_t* mask, const float* lut, int nq, int nprobe, int nlist,
                           int lmax, int m, int d, int ksub, int splits, int pps, int warps,
                           int k2, int slots, int vec4, float* part_s, int* part_p,
                           float* cmax, cudaStream_t stream) {
  const size_t smem = partial_smem(SMEM, m * ksub, pps, warps, slots);
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(ivf_pq_topk_partial<L2, SMEM, VEC>), smem);
  if (err != cudaSuccess) return err;
  ivf_pq_topk_partial<L2, SMEM, VEC><<<dim3(nq, splits), 32 * warps, smem, stream>>>(
      lists, counts, rt, probe_ids, xq, centroids, mask, lut, nprobe, nlist, lmax, m, d, ksub,
      pps, k2, slots, vec4, part_s, part_p, cmax);
  return cudaGetLastError();
}

template <bool L2, bool SMEM>
cudaError_t launch_partial_vec(int vec, const uint8_t* lists, const int* counts, const float* rt,
                               const int* probe_ids, const float* xq, const float* centroids,
                               const int8_t* mask, const float* lut, int nq, int nprobe,
                               int nlist, int lmax, int m, int d, int ksub, int splits, int pps,
                               int warps, int k2, int slots, int vec4, float* part_s,
                               int* part_p, float* cmax, cudaStream_t stream) {
#define DFX_PARTIAL(V)                                                                        \
  launch_partial<L2, SMEM, V>(lists, counts, rt, probe_ids, xq, centroids, mask, lut, nq,    \
                              nprobe, nlist, lmax, m, d, ksub, splits, pps, warps, k2, slots, \
                              vec4, part_s, part_p, cmax, stream)
  switch (vec) {
    case 16: return DFX_PARTIAL(16);
    case 8: return DFX_PARTIAL(8);
    case 4: return DFX_PARTIAL(4);
    case 1: return DFX_PARTIAL(1);
    default: return cudaErrorInvalidValue;
  }
#undef DFX_PARTIAL
}

template <bool RQ, bool L2>
cudaError_t launch_merge(const uint8_t* lists, const int* row_pos, const int* probe_ids,
                         const float* xq, const float* centroids, const float* codebooks,
                         const float* part_s, const int* part_p, const float* cmax,
                         const float* cbn, int nq, int nprobe, int lmax, int m, int d, int ksub,
                         int dsub, int splits, int k, int k2, int slots, int warps,
                         float* out_s, int* out_p, int* unproven, cudaStream_t stream) {
  const size_t smem = (sizeof(float) + sizeof(int)) * static_cast<size_t>(warps) * slots;
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(ivf_pq_topk_merge<RQ, L2>), smem);
  if (err != cudaSuccess) return err;
  ivf_pq_topk_merge<RQ, L2><<<(nq + warps - 1) / warps, 32 * warps, smem, stream>>>(
      lists, row_pos, probe_ids, xq, centroids, codebooks, part_s, part_p, cmax, cbn, nq,
      nprobe, lmax, m, d, ksub, dsub, splits, k, k2, slots, out_s, out_p, unproven);
  return cudaGetLastError();
}

}  // namespace

// Runs the launches named by `stages` (1 the table, 2 the scan, 4 the merge)
// in that order on `stream`; returns the CUDA error of the first that fails
// (0 on success).  The wrapper (ops/ivf_pq_scan.py) checks the inputs and
// sizes the buffers: lut (nq, m, ksub), cbn (m * ceil(ksub / 64),), part_s
// / part_p (nq, splits, k2), cmax (nq, splits), out_s / out_p (nq, k), and
// unproven one int it reads or zeroes.  ksub a power of two <= 256 (dsub
// unused for RQ); splits * pps >= nprobe; slots a power of two >= k2 + 32
// and merge_slots one >= max(2 k2, k2 + 32); vec 16, 8, 4 or 1 dividing m
// with the codes vec-aligned; vec4 = 1 only with d a multiple of 4 and
// 16-byte aligned xq and centroids; smem_lut = 1 only when the m * ksub
// table fits beside the rest (partial_smem).
extern "C" int dfx_ivf_pq_topk(const uint8_t* lists, const int* counts, const float* rt,
                               const int* row_pos, const int* probe_ids, const float* xq,
                               const float* centroids, const float* codebooks,
                               const int8_t* mask, int nq, int nprobe, int nlist, int lmax, int m,
                               int d, int ksub, int dsub, int k, int rq, int l2, int smem_lut,
                               int vec, int vec4, int splits, int pps, int warps, int k2,
                               int slots, int merge_slots, int merge_warps, float* lut,
                               float* cbn, float* part_s, int* part_p, float* cmax, float* out_s,
                               int* out_p, int* unproven, int stages, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    const dim3 grid((nq + kLutQ - 1) / kLutQ, m * ((ksub + kLutE - 1) / kLutE));
    if (rq)
      pq_lut_kernel<true><<<grid, kThreads, 0, stream>>>(xq, codebooks, nq, d, m, ksub, dsub,
                                                         lut, cbn);
    else
      pq_lut_kernel<false><<<grid, kThreads, 0, stream>>>(xq, codebooks, nq, d, m, ksub, dsub,
                                                          lut, cbn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
#define DFX_PARTIAL(L2, SMEM)                                                                  \
  launch_partial_vec<L2, SMEM>(vec, lists, counts, rt, probe_ids, xq, centroids, mask, lut, nq, \
                               nprobe, nlist, lmax, m, d, ksub, splits, pps, warps, k2, slots,  \
                               vec4, part_s, part_p, cmax, stream)
    if (l2)
      err = smem_lut ? DFX_PARTIAL(true, true) : DFX_PARTIAL(true, false);
    else
      err = smem_lut ? DFX_PARTIAL(false, true) : DFX_PARTIAL(false, false);
#undef DFX_PARTIAL
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 4) {
#define DFX_MERGE(RQ, L2)                                                                        \
  launch_merge<RQ, L2>(lists, row_pos, probe_ids, xq, centroids, codebooks, part_s, part_p, cmax, \
                       cbn, nq, nprobe, lmax, m, d, ksub, dsub, splits, k, k2, merge_slots,      \
                       merge_warps, out_s, out_p, unproven, stream)
    if (rq)
      err = l2 ? DFX_MERGE(true, true) : DFX_MERGE(true, false);
    else
      err = l2 ? DFX_MERGE(false, true) : DFX_MERGE(false, false);
#undef DFX_MERGE
  }
  return static_cast<int>(err);
}
