// A per-query list scan that ends in its top-k, for Hopper (sm_90a): the
// skeleton of the fused IVF,Flat (K6, ivf_list_scan.cu) and IVF,SQ (K2,
// ivf_sq_scan.cu) list searches, with the row score as a template functor.
//
// Two launches, issued by one C call over one workspace:
//   (a) partial: grid = queries x splits.  A query's probed lists' live
//       rows (count <= lmax rows each, contiguous in the padded layout) cut
//       into chunks of up to 32 rows, in probe-slot order, make its
//       chunks; a block takes an equal share of them (a run of chunks that
//       may start or end inside a list), so a long list does not hold one
//       block long after the others; it reads list ids and counts on the
//       device.  One producer warp keeps
//       a ring of shared-memory stages full: a chunk is copied by one 1-D
//       bulk copy of the Tensor Memory Accelerator (cp.async.bulk with
//       complete_tx on the stage's `full` mbarrier) covering its bytes
//       rounded out to 16-byte boundaries; where the payload's base or end
//       is not 16-byte aligned, a cp.async instance (the producer warp's
//       lanes copy the same 16-byte granules, the last one clamped to the
//       payload's end) does it instead.  Rows at or past the count are
//       never copied (but for the rounding's few bytes) and never scored.
//       Consumer warps take the chunks in turn (item i to warp i % warps,
//       into stages of that warp's own: stage_of), score their rows out
//       of shared memory with the functor, which
//       leaves one row's score on each lane, and push those that are live
//       (row below the chunk's rows, mask byte not 0) into the warp's best
//       k2 (score, flat index = probe slot * lmax + slot) with
//       warp_topk.cuh; the stage goes back to the producer on `empty`.
//       Then the block's first consumer warp merges the other warps'
//       lists into its own and writes one sorted list of k2: (nq, splits,
//       k2) candidates.
//   (b) merge: one block a query merges its splits' lists (merge_splits),
//       then the kernel finishes: K6 resolves positions, K2 rescores.
// Ties go to the lower flat index in both launches, as exact_topk orders
// them; each row's score comes from one fixed lane arrangement (the
// functor's), so no plan changes a result.
//
// The functor's contract: `float score_chunk(const uint8_t* rows, int n,
// int64_t slot0, int lane, int& row)` scores rows [0, n) of a staged chunk
// (row r at rows + r * row_bytes, the chunk's first slot slot0 = list *
// lmax + r0), called by every lane of a warp, and returns this lane's row
// index and its score; a lane whose row is at or past n returns anything.
// Lanes may split a row (`lanes` a row, a power of two, lanes along the
// row in units); `reduce_scatter` sums each lane's partials of 32 / lanes
// rows a pass over `lanes` passes, so that each lane ends with one whole
// row: the sum of a row is a fixed tree over its lanes, the same for
// every row and every plan.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "warp_topk.cuh"

namespace ltk {

using wtk::kFull;
using wtk::kNoPos;
using wtk::push_sorted_lists;
using wtk::TopK;

constexpr int kChunkRows = 32;  // rows a chunk at most: one a lane

// The launch shape the wrapper plans (ops/ivf_list_scan.py::plan,
// ops/ivf_sq_scan.py::plan); the C calls take it as an int array in this
// order (kPlanInts).
struct Plan {
  int nq, nprobe, nlist, lmax;
  int row_bytes;    // bytes a padded row
  int k, k2;        // results a query; candidates a split
  int splits;       // blocks a query, each an equal share of its chunks
  int chunk_rows;   // rows a chunk, 1..32
  int stage_bytes;  // a stage, a multiple of 16 >= chunk_rows * row_bytes + 32
  int stages, warps;  // ring stages, a multiple of warps; consumer warps
  int slots;        // a warp's list: a power of two >= k2 + 32
  int merge_slots;  // the merge's list: a power of two >= max(2 k2, k2 + 32)
  int merge_warps;  // warps of a merge block
  int tma;          // 1: bulk copies; 0: the cp.async instance
  int smem, merge_smem;  // dynamic shared-memory bytes of (a) and (b)
};
constexpr int kPlanInts = 18;

static_assert(sizeof(Plan) == kPlanInts * sizeof(int), "Plan is kPlanInts ints");

__host__ inline Plan plan_from(const int* v) {
  Plan p;
  memcpy(&p, v, sizeof(Plan));
  return p;
}

// --- mbarriers and copies ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
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

// One 1-D bulk copy global -> shared completing on `bar`; dst, src and
// bytes multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes (src_bytes of them read, the rest zero); dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// `bar` tracks the completion of this thread's earlier cp.async copies (the
// pending count is raised now and lowered when they land).
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// --- the reduction a lane a row ----------------------------------------------

// One level of reduce_scatter: lanes whose bit HALF is set keep the upper
// half of the passes, the others the lower half, each adding its partner's
// partials of the passes it keeps.  Template recursion keeps every index
// a compile-time constant, so acc stays in registers.
template <int HALF, int L, typename T>
__device__ __forceinline__ void scatter_level(T (&acc)[L], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = (lane & HALF) != 0;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const T send = upper ? acc[j] : acc[j + HALF];
      const T keep = upper ? acc[j + HALF] : acc[j];
      acc[j] = keep + __shfl_xor_sync(kFull, send, HALF);
    }
    scatter_level<HALF / 2>(acc, lane);
  }
}

// acc[j] holds this lane's partial of pass j's row (row j * (32 / L) + lane
// / L of the chunk); afterwards acc[0] holds the whole sum of pass lane % L
// of this lane's group of L lanes.  L - 1 shuffles a lane.
template <int L, typename T>
__device__ __forceinline__ void reduce_scatter(T (&acc)[L], int lane) {
  scatter_level<L / 2>(acc, lane);
}

// The chunk row whose whole sum reduce_scatter leaves on `lane`.
template <int L>
__device__ __forceinline__ int scattered_row(int lane) {
  return (lane % L) * (32 / L) + lane / L;
}

// --- (a) the partial launch ----------------------------------------------------

// Item i goes to consumer warp i % warps, into that warp's own stages in
// turn: stage (i % warps) + warps * ((i / warps) % depth), in its round
// (i / warps) / depth, depth = stages / warps.  A stage is only ever read
// by one warp, in order, so no warp can wait on a phase two rounds ahead
// of a barrier (whose parity would then alias the finished round's).
__device__ __forceinline__ int stage_of(int i, const Plan& p) {
  return i % p.warps + p.warps * ((i / p.warps) % (p.stages / p.warps));
}

__device__ __forceinline__ int round_of(int i, const Plan& p) {
  return i / p.stages;
}

// A stage's item, written by the producer before it arrives on `full`.
struct Item {
  int slot;  // probe slot of the query; < 0: no more items for this warp
  int lid, r0, rows;
  int off;   // the chunk's first byte in the stage
  int pad[3];
};

// Shared memory of the partial launch before the functor's own: the ring,
// its items and barriers, the warps' lists.
__host__ __device__ inline size_t partial_head_bytes(const Plan& p) {
  return static_cast<size_t>(p.stages) * (p.stage_bytes + sizeof(Item) + 2 * sizeof(uint64_t)) +
         8 * static_cast<size_t>(p.warps) * p.slots;
}

struct Ring {
  uint8_t* stages;
  Item* items;
  uint64_t* full;
  uint64_t* empty;
  float* lists_s;  // warp w's list at 2 w slots: scores, then positions
};

__device__ inline Ring carve(uint8_t* smem, const Plan& p) {
  Ring r;
  r.stages = smem;
  r.items = reinterpret_cast<Item*>(smem + static_cast<size_t>(p.stages) * p.stage_bytes);
  r.full = reinterpret_cast<uint64_t*>(r.items + p.stages);
  r.empty = r.full + p.stages;
  r.lists_s = reinterpret_cast<float*>(r.empty + p.stages);
  return r;
}

// Probe slot j of query q: its list id (0 for a dead slot), live rows and
// chunks.
struct Slot {
  int lid, cnt, chunks;
};

__device__ __forceinline__ Slot slot_at(const Plan& p, const int* __restrict__ probe_ids,
                                        const int* __restrict__ counts, int64_t q, int j) {
  const int lid = probe_ids[q * p.nprobe + j];
  const bool live = lid >= 0 && lid < p.nlist;
  const int cnt = live ? min(max(counts[lid], 0), p.lmax) : 0;
  return Slot{live ? lid : 0, cnt, (cnt + p.chunk_rows - 1) / p.chunk_rows};
}

// The producer warp (all 32 lanes, converged): chunks [c0, c1) of query q's
// chunks (its probe slots' in order), then one end item a consumer warp.
// Split `split` takes c0 = split * ceil(T / splits) of the T chunks.
__device__ inline void produce(const Ring& r, const Plan& p, const uint8_t* payload,
                               const int* __restrict__ counts, const int* __restrict__ probe_ids,
                               int64_t q, int split, int lane) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(payload);
  const uintptr_t end =
      start + static_cast<uintptr_t>(p.nlist) * p.lmax * static_cast<uintptr_t>(p.row_bytes);
  int total = 0;
  for (int j = lane; j < p.nprobe; j += 32) total += slot_at(p, probe_ids, counts, q, j).chunks;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off);
  const int per = (total + p.splits - 1) / p.splits;
  const int c0 = min(total, split * per), c1 = min(total, c0 + per);
  // The slot holding chunk c0, 32 slots at a time, and the chunks before it.
  int slot = 0, before = 0;
  for (int j0 = 0; c0 < c1 && j0 < p.nprobe; j0 += 32) {
    const int n = j0 + lane < p.nprobe ? slot_at(p, probe_ids, counts, q, j0 + lane).chunks : 0;
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const unsigned past = __ballot_sync(kFull, before + incl > c0);
    if (past) {
      const int t = __ffs(past) - 1;
      slot = j0 + t;
      before += __shfl_sync(kFull, incl - n, t);
      break;
    }
    before += __shfl_sync(kFull, incl, 31);
  }
  Slot sl = c0 < c1 ? slot_at(p, probe_ids, counts, q, slot) : Slot{0, 0, 0};
  int r0 = (c0 - before) * p.chunk_rows;  // first row of the next chunk in the slot
  int ends = 0;
  for (int i = 0, g = c0; ends < p.warps; ++i, ++g) {
    const int s = stage_of(i, p);
    uint64_t* full = &r.full[s];
    bar_wait(&r.empty[s], (round_of(i, p) & 1) ^ 1);
    if (g >= c1) {  // an end item
      if (lane == 0) r.items[s] = Item{-1, 0, 0, 0, 0, {0, 0, 0}};
      if (p.tma) {
        if (lane == 0) bar_arrive(full);
      } else {
        bar_arrive(full);
      }
      ++ends;
      continue;
    }
    while (r0 >= sl.cnt) {  // on to the next slot with rows; chunk g lies ahead
      sl = slot_at(p, probe_ids, counts, q, ++slot);
      r0 = 0;
    }
    const int lid = sl.lid;
    const int rows = min(p.chunk_rows, sl.cnt - r0);
    const uintptr_t a = start + (static_cast<uintptr_t>(lid) * p.lmax + r0) *
                                    static_cast<uintptr_t>(p.row_bytes);
    const uintptr_t a16 = a & ~static_cast<uintptr_t>(15);
    const uint32_t bytes = static_cast<uint32_t>(
        ((a + static_cast<uintptr_t>(rows) * p.row_bytes + 15) & ~static_cast<uintptr_t>(15)) -
        a16);
    uint8_t* dst = r.stages + static_cast<size_t>(s) * p.stage_bytes;
    if (lane == 0)
      r.items[s] = Item{slot, lid, r0, rows, static_cast<int>(a - a16), {0, 0, 0}};
    if (p.tma) {
      if (lane == 0) {
        bar_expect(full, bytes);
        bulk_copy(dst, reinterpret_cast<const void*>(a16), bytes, full);
      }
    } else {
      for (uint32_t o = 16 * lane; o < bytes; o += 32 * 16) {
        const uintptr_t src = a16 + o;
        const int avail = src >= end ? 0 : end - src < 16 ? static_cast<int>(end - src) : 16;
        copy16(dst + o, reinterpret_cast<const void*>(avail ? src : a16), avail);
      }
      copies_arrive(full);
      bar_arrive(full);
    }
    r0 += p.chunk_rows;
  }
}

// The partial launch's body; the kernel stages the functor's query data in
// shared memory first (before the barrier below).  The block takes split
// blockIdx.y of query blockIdx.x's chunks; thread block = one producer warp
// and p.warps consumer warps.
template <class Score>
__device__ inline void partial(const Score& score, uint8_t* smem, const Plan& p,
                               const uint8_t* __restrict__ payload, const int* __restrict__ counts,
                               const int* __restrict__ probe_ids, const int8_t* __restrict__ mask,
                               float* __restrict__ part_s, int* __restrict__ part_p) {
  const Ring r = carve(smem, p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x, split = blockIdx.y;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      bar_init(&r.full[s], p.tma ? 1 : 32);
      bar_init(&r.empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int cw = warp - 1;  // consumer warp, -1 for the producer
  TopK top;
  if (cw < 0) {
    produce(r, p, payload, counts, probe_ids, q, split, lane);
  } else {
    float* top_s = r.lists_s + 2 * static_cast<size_t>(cw) * p.slots;
    top.init(top_s, reinterpret_cast<int*>(top_s + p.slots), p.k2, p.slots, lane);
    for (int i = cw;; i += p.warps) {
      const int s = stage_of(i, p);
      bar_wait(&r.full[s], round_of(i, p) & 1);
      const Item it = r.items[s];
      if (it.slot < 0) break;  // warp-uniform
      const int64_t slot0 = static_cast<int64_t>(it.lid) * p.lmax + it.r0;
      int row;
      const float sc = score.score_chunk(
          r.stages + static_cast<size_t>(s) * p.stage_bytes + it.off, it.rows, slot0, lane, row);
      __syncwarp();
      if (lane == 0) bar_arrive(&r.empty[s]);
      const bool valid = row < it.rows && (mask == nullptr || mask[slot0 + row] != 0);
      top.push(valid, sc, it.slot * p.lmax + it.r0 + row, lane);
    }
    if (top.cnt > 0) top.flush(lane);
  }
  __syncthreads();
  if (warp != 1) return;  // the first consumer warp merges the others' lists
  push_sorted_lists(top, r.lists_s + 2 * p.slots,
                    reinterpret_cast<const int*>(r.lists_s + 3 * p.slots), p.warps - 1, lane,
                    2 * p.slots);
  if (top.cnt > 0) top.flush(lane);
  const int64_t out = (static_cast<int64_t>(q) * p.splits + split) * p.k2;
  for (int t = lane; t < p.k2; t += 32) {
    part_s[out + t] = top.s[t];
    part_p[out + t] = top.p[t];
  }
}

// --- (b) the merge ---------------------------------------------------------------

// One warp merges query q's splits' sorted lists into the best k2, sorted
// by (score desc, flat index asc), in (s, p): merge_slots slots.
__device__ inline void merge_splits(TopK& top, float* s, int* p, const Plan& pl,
                                    const float* __restrict__ part_s,
                                    const int* __restrict__ part_p, int q, int lane) {
  top.init(s, p, pl.k2, pl.merge_slots, lane);
  const int64_t at = static_cast<int64_t>(q) * pl.splits * pl.k2;
  push_sorted_lists(top, part_s + at, part_p + at, pl.splits, lane, pl.k2);
  if (top.cnt > 0) top.flush(lane);
}

// Storage row of a flat index of query q (-1 where none).
__device__ __forceinline__ int resolve(int flat, const Plan& pl, const int* __restrict__ probe_ids,
                                       const int* __restrict__ row_pos, int q) {
  if (flat == kNoPos) return -1;
  const int slot = flat / pl.lmax;
  const int lid = probe_ids[static_cast<int64_t>(q) * pl.nprobe + slot];
  if (lid < 0 || lid >= pl.nlist) return -1;
  return row_pos[static_cast<int64_t>(lid) * pl.lmax + flat - slot * pl.lmax];
}

__host__ inline cudaError_t set_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace ltk
