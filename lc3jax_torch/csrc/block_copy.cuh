// Block-wide copies between device and shared memory, for the kernels that
// stage their streams' rows (parse.cu, pack.cu).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lc3t {

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// n bytes from src to dst by all of the block's threads, 16 at a time where
// both ends allow it, then byte by byte.
__device__ __forceinline__ void block_copy(uint8_t* dst, const uint8_t* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n16 = n >> 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = n16 << 4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace lc3t
