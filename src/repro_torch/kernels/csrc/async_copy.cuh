// async_copy.cuh - the asynchronous global -> shared copies (cp.async,
// sm_80 and later) that the int8 tensor-core kernels (int8_mma.cuh) and
// the split-K CiM GEMM (cluster_gemm.cuh) fill their operand rings with.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cim {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously: the first `bytes` (0..16)
// are copied and the rest of the 16 zero-filled; `src` must be a valid
// 16-byte aligned address even when `bytes` is 0
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes global -> shared, asynchronously; `valid` false zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  cp_async16_n(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cim
