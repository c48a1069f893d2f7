// Staging of a block's rows of f32 spectral lines in shared memory, and
// their way back, for the TNS lattices (tns_analysis.cu, tns_synthesis.cu).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lc3t {

// Asynchronous copies from device to shared memory (cp.async): they hold no
// register and do not wait, so all of a thread's copies are in flight at
// once. 16 bytes where both ends are 16-byte aligned, else 4.
__device__ __forceinline__ void copy_async_16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Waits for this thread's copies; a __syncthreads() after it makes every
// thread's visible to the block.
__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p, int ne) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && (ne & 3) == 0;
}

// Starts the copy of nrows rows of ne floats (src, contiguous) into shared
// rows at dst of stride `row` (a multiple of 4), spread over the block's
// kThreads threads.
template <int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, int row, const float* src, int ne,
                                           int nrows) {
  if (aligned16(src, ne)) {
    for (int i = threadIdx.x; i < nrows * ne / 4; i += kThreads) {
      const int u = 4 * i / ne, n = 4 * i - u * ne;
      copy_async_16(dst + u * row + n, src + 4 * i);
    }
  } else {
    for (int u = 0; u < nrows; ++u)
      for (int n = threadIdx.x; n < ne; n += kThreads)
        copy_async_4(dst + u * row + n, src + (size_t)u * ne + n);
  }
}

// Stores nrows shared rows of stride `row` (a multiple of 4) at src into
// nrows rows of ne floats at dst (contiguous), 16 bytes a thread where dst
// allows it.
template <int kThreads>
__device__ __forceinline__ void store_rows(float* dst, const float* src, int row, int ne,
                                           int nrows) {
  if (aligned16(dst, ne)) {
    for (int i = threadIdx.x; i < nrows * ne / 4; i += kThreads) {
      const int u = 4 * i / ne, n = 4 * i - u * ne;
      reinterpret_cast<float4*>(dst)[i] = *reinterpret_cast<const float4*>(src + u * row + n);
    }
  } else {
    for (int u = 0; u < nrows; ++u)
      for (int n = threadIdx.x; n < ne; n += kThreads) dst[(size_t)u * ne + n] = src[u * row + n];
  }
}

}  // namespace lc3t
