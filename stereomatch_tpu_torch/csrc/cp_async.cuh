// cp.async: an asynchronous copy from device to shared memory that the
// issuing thread waits for by commit group.  16-byte copies skip L1 (.cg,
// the volumes are streamed); 4-byte copies go through it (.ca, the only
// form for that size).  Shared by the rings of sgm.cu and dp.cu (and
// bf16.cuh's row staging).
#pragma once

#include <cuda_runtime.h>

namespace stm {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copies issued only where `live` holds: a predicated instruction, no
// branch.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool live) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(static_cast<int>(live))
      : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool live) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(static_cast<int>(live))
      : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace stm
