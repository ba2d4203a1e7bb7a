// Asynchronous device-memory -> shared-memory copies (cp.async), the ring
// both pipelined pair-tile kernels for Hopper (sm_90a) move their operands
// through: ivf_sq_pairs_mega.cu (K9) and ivf_pairs_mega.cu (K10).
//
// A thread issues copies, closes them into a commit group, and later waits
// until at most n of its groups are still in flight; __syncthreads() then
// makes every thread's landed copies visible to the block.  A copy given
// src_bytes below its size reads only those bytes and zero-fills the rest
// (src_bytes 0 reads nothing).

#pragma once

#include <stdint.h>

namespace cpa {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes; dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes; dst and src 4-byte aligned.
__device__ __forceinline__ void copy4(void* dst, const void* src, int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n (0..3) of this thread's commit groups are pending.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      break;
    case 1:
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      break;
    case 2:
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      break;
    default:
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
      break;
  }
}

}  // namespace cpa
