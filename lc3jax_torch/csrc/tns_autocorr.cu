// Encoder TNS autocorrelation: for each stream, 2 filters x 3 sub-blocks x
// lags 0..8, the sum of x[n] * x[n + k] over n in [lo, hi - k).
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_tns.py:_autocorr_kernel
// (entry tns_autocorr_pallas). The sum is the oracle's strict left-to-right
// f32 fold (lc3jax/ref/tns_enc.py:_autocorrelation): the Pallas and XLA
// versions reduce with jnp.sum in XLA's order, the port pins the oracle's.
// A tree reduction would break the equality with the plain PyTorch version,
// so each sum stays in one thread.
//
// What bounds it on the H100: little. The input is 1.6 KB per stream at
// 48 kHz / 10 ms (3.3 MB at S = 2048) and the work 54 dependent chains of
// at most ~67 multiply-adds per stream, so the device time is one load of
// the rows plus one chain's latency: 0.0072 ms at S = 2048 (chip_smoke.py,
// H100 80GB HBM3 at 700 W), where a caller waits 0.035 ms for the wrapper's
// host work and the launch; the wrapper is kept as lean as a PyTorch call.
// Design: one thread per (stream, filter, sub-block, lag), 110,592 threads
// at S = 2048, all resident at once; the 54 threads of a stream are
// neighbours, so their reads of one line hit the same cache lines and their
// 54 outputs are one contiguous store. Staging four rows a block in shared
// memory with 16-byte loads and a fold unrolled by 4 measured 0.0068 ms on
// the same card and inputs, within 5%, and was not kept.
//
// Exactness: compiled with --fmad=false: each product rounds before the add.
#include <cuda_runtime.h>

namespace {

__global__ void tns_autocorr_kernel(const float* __restrict__ x, const int* __restrict__ sub,
                                    float* __restrict__ out, int S, int ne) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= S * 54) return;
  const int s = tid / 54;
  const int r = tid - 54 * s;  // (f * 3 + sb) * 9 + k
  const int blk = r / 9;
  const int k = r - 9 * blk;
  const int lo = sub[12 * s + 2 * blk];
  const int hi = sub[12 * s + 2 * blk + 1];
  const float* xs = x + (size_t)s * ne;
  float acc = 0.0f;
  for (int n = lo; n + k < hi; ++n) acc = acc + xs[n] * xs[n + k];
  out[tid] = acc;
}

}  // namespace

// x: [S, ne] f32; sub: [S, 2, 3, 2] i32 (lo, hi); out: [S, 2, 3, 9] f32.
extern "C" int lc3t_tns_autocorr(const float* x, const int* sub, float* out, int S, int ne,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (S * 54 + threads - 1) / threads;
  tns_autocorr_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, sub, out, S, ne);
  return static_cast<int>(cudaGetLastError());
}
