// Encoder global gain estimate, one frame: the threshold folds over the
// reversed 4-line energies and the 8-step bisection over the 256 gain
// indices, to the index before the gain limitation.
//
// Replaces no `pallas_call`: lc3jax/dsp/encoder.py:988-1025 computes the
// bisection as XLA glue, which XLA fused into the jitted step on the TPU.
// Eager PyTorch ran it as about 13 ops over [S, 256] for each of the ne / 4
// energies, folding all 256 thresholds at once, then 8 gathers: 250-1,350
// graph nodes a step (ne / 4 = 15-100). Semantics:
// dsp/encoder.py:gain_bisection_plain, op for op; the oracle is
// lc3jax/ref/quant.py:_gain_bisection.
//
// What bounds it on the H100: a stream reads ne / 4 energies (400 bytes at
// 48 kHz / 10 ms) and its bit budget and writes one index, about 0.85 MB at
// S = 2048: under 0.3 µs at 3.35 TB/s. The arithmetic is small. What is
// left is each stream's chain: the bisection's 8 steps depend one on the
// other (each threshold follows the last step's decision), and each step's
// fold is ne / 4 dependent f32 adds in the oracle's order.
//
// Design: a thread a stream runs the oracle's 8 folds one after the other,
// 32 streams (one warp) a block. The block's energies are staged with
// coalesced loads and scaled once into shared memory (scaled and
// twice-scaled rows, 25.6 KB at ne / 4 = 100, the rows at an odd stride so
// that the warp's 32 rows fall in 32 banks). ne / 4 comes from the input's
// shape, gg_off and the divisor are arguments: one kernel for all twelve
// (fs, frame) configurations. Measured at 48 kHz / 10 ms, S = 2048 (H100
// 80GB HBM3, 700 W, chip_smoke.py phase 9): 0.040 ms on the device, one
// stream alone 0.019 ms (about 47 cycles a term: a term's loads and
// selects wait on each other). Two faster designs were measured and not
// kept, since 0.03 ms of a 4 ms step does not show end to end: a thread a
// (stream, gain index) folding all 256 as the plain version does, 0.031
// ms; a half-warp a stream testing in two rounds the 15 thresholds that 4
// steps can reach, so that the chain is 2 x ne / 4 terms, 0.012 ms.
//
// Exactness: compiled with --fmad=false, so every product and sum rounds on
// its own, like the eager ops of the plain version; each fold is the plain
// version's fold for that threshold: each term its expression in its
// association, selected as its torch.where selects, added to the running
// sum in the same order (the last energy first), and the test its `over`
// entry; the bisection reads the tests the plain version's gathers read.
// The divisions are __fdiv_rn, as PyTorch divides a tensor by the divisor's
// tensor; the four constants are the plain version's f32 values, passed in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStreams = 32;  // streams a block, a thread each

__global__ void __launch_bounds__(kStreams) gain_estimate_kernel(
    const float* __restrict__ e, const int64_t* __restrict__ nbits_spec_adj,
    const float* __restrict__ divisor, int64_t* __restrict__ gg_ind, int S, int n4, int gg_off,
    float c27, float c43, float c36, float c7) {
  extern __shared__ float smem[];
  const int stride = n4 | 1;
  float* sc_rows = smem;                       // (e * 28) / d,        [kStreams][stride]
  float* sc2_rows = smem + kStreams * stride;  // ((2 * e) * 28) / d,  [kStreams][stride]
  const int s0 = blockIdx.x * kStreams;
  const int rows = min(kStreams, S - s0);
  const float d = *divisor;
  const float* block_e = e + (size_t)s0 * n4;  // the block's rows, contiguous
  for (int k = threadIdx.x; k < rows * n4; k += kStreams) {
    const int r = k / n4, i = k - r * n4;
    const float v = block_e[k];
    sc_rows[r * stride + i] = __fdiv_rn(v * 28.0f, d);
    sc2_rows[r * stride + i] = __fdiv_rn((2.0f * v) * 28.0f, d);
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* sc_r = sc_rows + r * stride;
  const float* sc2_r = sc2_rows + r * stride;
  const float limit = __fdiv_rn((static_cast<float>(nbits_spec_adj[s0 + r]) * 1.4f) * 28.0f, d);
  int g = 255, fac = 256;
  for (int step = 0; step < 8; ++step) {
    fac >>= 1;
    g -= fac;
    const float thr = static_cast<float>(g + gg_off);  // exact
    const float thr2 = 2.0f * thr;
    float tmp = 0.0f;
    bool seen = false;
#pragma unroll 4
    for (int i = n4 - 1; i >= 0; --i) {
      const float sc = sc_r[i];
      const bool above = sc >= thr;
      const bool far = thr < sc - c43;
      const float a_term = far ? (sc2_r[i] - thr2) - c36 : (sc - thr) + c7;
      tmp = tmp + (above ? a_term : (seen ? c27 : 0.0f));
      seen = seen || above;
    }
    if (tmp > limit && seen) g += fac;
  }
  gg_ind[s0 + r] = g;
}

}  // namespace

extern "C" int lc3t_gain_estimate(const float* e, const int64_t* nbits_spec_adj,
                                  const float* divisor, int64_t* gg_ind, int S, int n4,
                                  int gg_off, float c27, float c43, float c36, float c7,
                                  void* stream) {
  const size_t smem = sizeof(float) * 2 * kStreams * (size_t)(n4 | 1);
  if (S < 1 || n4 < 1 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (S + kStreams - 1) / kStreams;
  gain_estimate_kernel<<<blocks, kStreams, smem, static_cast<cudaStream_t>(stream)>>>(
      e, nbits_spec_adj, divisor, gg_ind, S, n4, gg_off, c27, c43, c36, c7);
  return static_cast<int>(cudaGetLastError());
}
