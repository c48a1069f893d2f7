// The spectral bit model's table part (encoder): per spectral tuple, the
// arithmetic coder's cost of the escape ladder and of the final symbol, in
// 1/2048 bits, from AC_SPEC_LOOKUP and AC_SPEC_BITS by context.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_bitmodel.py:_kernel (entry
// bitmodel_table_part, without emit_pack); semantics of
// lc3jax/dsp/encoder.py:bit_consumption (:1189-1231). The TPU kernel fetched
// the tables with one-hot MXU matmuls, its workaround for gathers; here they
// are plain lookups in shared memory.
//
// What bounds it on the H100: 12 B in and 4 B out per tuple (at most 6.6 MB
// at S = 2048, NT = 200) and five table lookups; each block first copies the
// tables (4,096 + 1,088 entries) into shared memory, which at 256 threads a
// block is about as much traffic as the tuples themselves (served from L2).
// Design: one thread per (stream, tuple), tables in shared memory as int16
// and uint8, tuples past the stream's last coded one write 0.
//
// Exact integer arithmetic: equal to the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void bitmodel_kernel(const int* __restrict__ c, const int* __restrict__ g,
                                const int* __restrict__ sym, const int* __restrict__ lastnz,
                                const int* __restrict__ lut, const int* __restrict__ bits,
                                int* __restrict__ out, int S, int NT, int ne4,
                                int rate_flag) {
  __shared__ uint8_t s_lut[4096];
  __shared__ int16_t s_bits[64 * 17];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s_lut[i] = (uint8_t)lut[i];
  for (int i = threadIdx.x; i < 64 * 17; i += blockDim.x) s_bits[i] = (int16_t)bits[i];
  __syncthreads();
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long)S * NT) return;
  const int s = (int)(tid / NT);
  const int n = (int)(tid - (long)s * NT);
  if (n >= ((lastnz[s] + 1) >> 1)) {
    out[tid] = 0;
    return;
  }
  const int base = c[tid] + rate_flag + (n > ne4 ? 256 : 0);
  const int gv = g[tid];
  int pki[4];
#pragma unroll
  for (int L = 0; L < 4; ++L) pki[L] = s_lut[base + 1024 * L];
  int est = 0;
#pragma unroll
  for (int L = 0; L < 3; ++L)
    if (gv > L) est += s_bits[17 * pki[L] + 16];
  if (gv > 3) est += (gv - 3) * s_bits[17 * pki[3] + 16];
  const int lev = gv < 3 ? gv : 3;
  est += s_bits[17 * pki[lev] + sym[tid]];
  out[tid] = est;
}

}  // namespace

// c, g, sym, out: [S, NT] i32; lastnz: [S] i32; lut: [4096] i32; bits:
// [64, 17] i32 (AC_SPEC_LOOKUP, AC_SPEC_BITS on the device).
extern "C" int lc3t_bitmodel(const int* c, const int* g, const int* sym, const int* lastnz,
                             const int* lut, const int* bits, int* out, int S, int NT,
                             int ne4, int rate_flag, void* stream) {
  const long total = (long)S * NT;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  if (blocks == 0) return 0;
  bitmodel_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, g, sym, lastnz, lut, bits, out, S, NT, ne4, rate_flag);
  return static_cast<int>(cudaGetLastError());
}
