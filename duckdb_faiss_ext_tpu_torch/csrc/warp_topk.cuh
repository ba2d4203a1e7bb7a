// Running top-k lists in shared memory, each owned by one warp: the bitonic
// sort and the threshold / append machinery shared by the split-and-merge
// top-k kernels for Hopper (sm_90a): flat_topk.cu (K1) and ivf_pq_scan.cu
// (K8).  A list holds (score, position) slots sorted best-first by score
// descending, then position ascending; kNoPos marks an empty slot.

#pragma once

#include <math.h>

namespace wtk {

constexpr int kNoPos = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int p, float ts, int tp) {
  return s > ts || (s == ts && p < tp);
}

// Bitonic sort of n (a power of two) slots best-first, by one warp.
__device__ inline void warp_sort(float* s, int* p, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < (n >> 1); i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const float sl = s[lo], sh = s[hi];
        const int pl = p[lo], ph = p[hi];
        const bool swap = (lo & size) == 0 ? better(sh, ph, sl, pl)
                                           : better(sl, pl, sh, ph);
        if (swap) {
          s[lo] = sh; s[hi] = sl;
          p[lo] = ph; p[hi] = pl;
        }
      }
      __syncwarp();
    }
  }
}

// Sort slots [0, used) of a list best-first (padding to a power of two).
__device__ inline void sort_used(float* s, int* p, int used, int lane) {
  int n = 1;
  while (n < used) n <<= 1;
  for (int i = used + lane; i < n; i += 32) { s[i] = -INFINITY; p[i] = kNoPos; }
  __syncwarp();
  warp_sort(s, p, n, lane);
}

// One query's running top-k in the merge, owned by one warp.  Slots [0, k)
// are the best k so far, sorted; [k, k + cnt) unsorted candidates; (ts, tp)
// is slot k-1.
struct TopK {
  float* s;
  int* p;
  int k;
  int buf;      // candidate capacity: slots - k
  int cnt;
  float ts;
  int tp;

  __device__ void init(float* s_, int* p_, int k_, int slots, int lane) {
    s = s_; p = p_; k = k_; buf = slots - k_; cnt = 0;
    ts = -INFINITY; tp = kNoPos;
    for (int i = lane; i < k; i += 32) { s[i] = -INFINITY; p[i] = kNoPos; }
    __syncwarp();
  }

  __device__ void flush(int lane) {
    sort_used(s, p, k + cnt, lane);
    ts = s[k - 1];
    tp = p[k - 1];
    cnt = 0;
    __syncwarp();
  }

  __device__ __forceinline__ bool passes(bool valid, float sc, int pos) const {
    return valid && better(sc, pos, ts, tp);
  }

  // One candidate per lane; all 32 lanes call together.
  __device__ void push(bool valid, float sc, int pos, int lane) {
    bool pass = passes(valid, sc, pos);
    unsigned b = __ballot_sync(kFull, pass);
    if (b == 0) return;
    if (cnt + __popc(b) > buf) {
      flush(lane);
      pass = passes(valid, sc, pos);
      b = __ballot_sync(kFull, pass);
    }
    if (pass) {
      const int at = k + cnt + __popc(b & ((1u << lane) - 1u));
      s[at] = sc;
      p[at] = pos;
    }
    cnt += __popc(b);
  }
};

// Push the entries of `lists` lists of top.k slots each, every list sorted
// best-first, into top: list i's scores at qs + i * stride, its positions
// at qp + i * stride (stride top.k: one list after another).
__device__ inline void push_sorted_lists(TopK& top, const float* qs, const int* qp, int lists,
                                         int lane, int stride) {
  const int k2 = top.k;
  if (k2 < 32) {
    // Short lists: each step reads 32 / k2 whole lists, one entry a lane.
    const int per = 32 / k2;
    for (int sp0 = 0; sp0 < lists; sp0 += per) {
      const int sp = sp0 + lane / k2;
      float sc = -INFINITY;
      int pos = kNoPos;
      if (lane < per * k2 && sp < lists) {
        sc = qs[sp * stride + lane % k2];
        pos = qp[sp * stride + lane % k2];
      }
      top.push(pos != kNoPos, sc, pos, lane);
    }
    return;
  }
  for (int sp = 0; sp < lists; ++sp) {
    for (int base = 0; base < k2; base += 32) {
      const int idx = base + lane;
      float sc = -INFINITY;
      int pos = kNoPos;
      if (idx < k2) {
        sc = qs[sp * stride + idx];
        pos = qp[sp * stride + idx];
      }
      const bool valid = pos != kNoPos;
      // Each list is sorted best-first: once 32 entries in a row fail the
      // threshold, the rest of the list fails it too.
      if (__ballot_sync(kFull, top.passes(valid, sc, pos)) == 0) break;
      top.push(valid, sc, pos, lane);
    }
  }
}

}  // namespace wtk
