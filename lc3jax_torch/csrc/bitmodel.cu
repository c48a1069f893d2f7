// The spectral bit model's table part (encoder): per spectral tuple, the
// arithmetic coder's cost of the escape ladder and of the final symbol, in
// 1/2048 bits, from AC_SPEC_LOOKUP and AC_SPEC_BITS by context; and, with
// emit_pack, the range coder's operands for the same tuple.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_bitmodel.py:_kernel (entry
// bitmodel_table_part, with and without emit_pack); semantics of
// lc3jax/dsp/encoder.py:bit_consumption (:1189-1261). The TPU kernel fetched
// the tables with one-hot MXU matmuls, its workaround for gathers; here they
// are plain lookups in shared memory.
//
// emit_pack writes int32 [5 * NT, S], stream-minor so that the pack kernel's
// thread per stream reads it coalesced: row L * NT + n (L = 0..3) holds
// AC_SPEC_CUMFREQ[pki_L, 16] + 1024 * AC_SPEC_FREQ[pki_L, 16], the escape
// symbol at ladder level L; row 4 * NT + n the final symbol's cum + 1024 *
// freq at level min(g, 3). The JAX pad of the rows to a multiple of 8 was
// TPU tiling and is not kept.
//
// What bounds it on the H100: 12 B in and 4 B out per tuple (at most 6.6 MB
// at S = 2048, NT = 200) and five table lookups, plus 20 B out per tuple with
// emit_pack; each block first copies the tables (4,096 + 1,088 entries, and
// 2 x 1,088 more with emit_pack) into shared memory, which at 256 threads a
// block is about as much traffic as the tuples themselves (served from L2).
// Design: one thread per (stream, tuple), tables in shared memory as int16
// and uint8, tuples past the stream's last coded one write 0. A warp's
// threads are neighbouring tuples of one stream, so the stream-minor
// emit_pack rows are written 4 B per 32 B sector: simple, not yet fast.
//
// Exact integer arithmetic: equal to the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 64 * 17;

__global__ void bitmodel_kernel(const int* __restrict__ c, const int* __restrict__ g,
                                const int* __restrict__ sym, const int* __restrict__ lastnz,
                                const int* __restrict__ lut, const int* __restrict__ bits,
                                const int* __restrict__ cumfreq, const int* __restrict__ freq,
                                int* __restrict__ out, int* __restrict__ pk, int S, int NT,
                                int ne4, int rate_flag) {
  __shared__ uint8_t s_lut[4096];
  __shared__ int16_t s_bits[kTab];
  __shared__ int16_t s_cum[kTab];
  __shared__ int16_t s_freq[kTab];
  const bool emit = pk != nullptr;  // uniform over the launch
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s_lut[i] = (uint8_t)lut[i];
  for (int i = threadIdx.x; i < kTab; i += blockDim.x) s_bits[i] = (int16_t)bits[i];
  if (emit) {
    for (int i = threadIdx.x; i < kTab; i += blockDim.x) {
      s_cum[i] = (int16_t)cumfreq[i];
      s_freq[i] = (int16_t)freq[i];
    }
  }
  __syncthreads();
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long)S * NT) return;
  const int s = (int)(tid / NT);
  const int n = (int)(tid - (long)s * NT);
  if (n >= ((lastnz[s] + 1) >> 1)) {
    out[tid] = 0;
    if (emit) {
#pragma unroll
      for (int r = 0; r < 5; ++r) pk[((long)r * NT + n) * S + s] = 0;
    }
    return;
  }
  const int base = c[tid] + rate_flag + (n > ne4 ? 256 : 0);
  const int gv = g[tid];
  const int sv = sym[tid];
  int pki[4];
#pragma unroll
  for (int L = 0; L < 4; ++L) pki[L] = s_lut[base + 1024 * L];
  int est = 0;
#pragma unroll
  for (int L = 0; L < 3; ++L)
    if (gv > L) est += s_bits[17 * pki[L] + 16];
  if (gv > 3) est += (gv - 3) * s_bits[17 * pki[3] + 16];
  const int lev = gv < 3 ? gv : 3;
  est += s_bits[17 * pki[lev] + sv];
  out[tid] = est;
  if (emit) {
#pragma unroll
    for (int L = 0; L < 4; ++L) {
      const int e = 17 * pki[L] + 16;
      pk[((long)L * NT + n) * S + s] = s_cum[e] + 1024 * s_freq[e];
    }
    const int f = 17 * pki[lev] + sv;
    pk[((long)4 * NT + n) * S + s] = s_cum[f] + 1024 * s_freq[f];
  }
}

}  // namespace

// c, g, sym, out: [S, NT] i32; lastnz: [S] i32; lut: [4096] i32; bits, cumfreq,
// freq: [64, 17] i32 (AC_SPEC_LOOKUP, AC_SPEC_BITS, AC_SPEC_CUMFREQ,
// AC_SPEC_FREQ on the device). pk: [5 * NT, S] i32, or null without emit_pack
// (cumfreq and freq are then not read).
extern "C" int lc3t_bitmodel(const int* c, const int* g, const int* sym, const int* lastnz,
                             const int* lut, const int* bits, const int* cumfreq,
                             const int* freq, int* out, int* pk, int S, int NT, int ne4,
                             int rate_flag, void* stream) {
  const long total = (long)S * NT;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  if (blocks == 0) return 0;
  bitmodel_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, g, sym, lastnz, lut, bits, cumfreq, freq, out, pk, S, NT, ne4, rate_flag);
  return static_cast<int>(cudaGetLastError());
}
