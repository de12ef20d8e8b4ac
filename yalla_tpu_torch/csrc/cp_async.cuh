// Asynchronous copies from device memory to shared memory (cp.async,
// sm_80 and later), shared by the kernels that stage tiles: lattice_pair.cu
// (K1), tile_pair.cu (K3), central_pair.cu (K4) and gabriel_pair.cu (K5).
#pragma once

#include <cuda_runtime.h>

namespace yalla {

// 4-byte asynchronous copy of *gmem into *smem
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// close the copies started since the last commit into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace yalla
