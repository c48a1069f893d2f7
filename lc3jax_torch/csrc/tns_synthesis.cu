// Inverse TNS (decoder): the 8-tap IIR lattice over spectral lines, up to
// two filters per frame.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_tns.py:_tns_kernel (entry
// tns_synthesis_pallas); semantics of lc3jax/dsp/decoder.py:tns_synthesis.
//
// What bounds it on the H100: the lattice is a serial recurrence over ne
// lines per stream (8 dependent multiply-subtract steps per line), so the
// work is latency-bound, and one frame offers no parallelism beyond its
// stream. Design: one thread per stream with the 8 lattice states in
// registers; lines are read and written in a [ne, S] layout (streams on the
// fast axis), so each warp touches 32 consecutive floats per line and every
// access is coalesced. At S = 2048 that is 16 blocks of 128 threads, far
// below the 132 SMs' capacity: the kernel is bound by the per-thread chain,
// not by bandwidth (0.65 MB each way).
//
// Exactness: the state update follows _tns_kernel (pallas_tns.py:46-68):
// lattice rows change only on active lines, the pass-through line is copied.
// The library is compiled with --fmad=false, so each multiply and subtract
// rounds like the eager PyTorch ops of tns_synthesis_plain.
#include <cuda_runtime.h>

namespace {

__global__ void tns_synthesis_kernel(const float* __restrict__ x_t,
                                     const float* __restrict__ rc_q,
                                     const int* __restrict__ bounds,
                                     const int* __restrict__ order,
                                     float* __restrict__ out_t, int S, int ne) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int lo0 = bounds[4 * s + 0], hi0 = bounds[4 * s + 1];
  const int lo1 = bounds[4 * s + 2], hi1 = bounds[4 * s + 3];
  const int ord0 = order[2 * s + 0], ord1 = order[2 * s + 1];
  float rc0[8], rc1[8], st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    rc0[k] = rc_q[16 * s + k];
    rc1[k] = rc_q[16 * s + 8 + k];
    st[k] = 0.0f;
  }
  for (int n = 0; n < ne; ++n) {
    const float xv = x_t[(size_t)n * S + s];
    const bool in_f0 = n >= lo0 && n < hi0 && ord0 > 0;
    const bool in_f1 = n >= lo1 && n < hi1 && ord1 > 0;
    if (!(in_f0 || in_f1)) {
      out_t[(size_t)n * S + s] = xv;
      continue;
    }
    const int ord = in_f1 ? ord1 : ord0;
    float t = xv;
    float ns[8];
#pragma unroll
    for (int kk = 7; kk >= 0; --kk) {
      const float rc = in_f1 ? rc1[kk] : rc0[kk];
      if (kk < ord) t = t - rc * st[kk];
      if (kk < 7) ns[kk + 1] = (kk < ord - 1) ? rc * t + st[kk] : st[kk + 1];
    }
    st[0] = t;
#pragma unroll
    for (int k = 1; k < 8; ++k) st[k] = ns[k];
    out_t[(size_t)n * S + s] = t;
  }
}

}  // namespace

// x_t, out_t: [ne, S] f32; rc_q: [S, 16] f32; bounds: [S, 4] i32 (lo0, hi0,
// lo1, hi1); order: [S, 2] i32.
extern "C" int lc3t_tns_synthesis(const float* x_t, const float* rc_q,
                                  const int* bounds, const int* order,
                                  float* out_t, int S, int ne, void* stream) {
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  tns_synthesis_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x_t, rc_q, bounds, order, out_t, S, ne);
  return static_cast<int>(cudaGetLastError());
}
