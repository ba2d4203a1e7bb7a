// 2-D tensor copies of the Tensor Memory Accelerator, for Hopper (sm_90a):
// the tensor-map encoder, found at run time, and the box copy the
// TMA producer warps of ivf_sq_pairs_mega.cu (K9) and ivf_pairs_mega.cu
// (K10) issue.  cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so no library beyond the runtime is linked.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma2d {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (nullptr
// where it is missing).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The box of `map` at (x, y) into shared memory at dst, completing its
// bytes on the mbarrier `bar`.
__device__ __forceinline__ void box(void* dst, const CUtensorMap* map, int x, int y,
                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

}  // namespace tma2d
