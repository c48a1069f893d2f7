// Encoder TNS analysis: the forward 8-tap lattice over spectral lines, up to
// two filters per frame.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_tns.py:_tns_enc_kernel
// (entry tns_analysis_pallas); semantics of the XLA scan at
// lc3jax/dsp/encoder.py:877-913, including its pick of the last tap
// (:900-908): the tap at order - 1 reads the state as it was before the
// line and is the only one that takes st_save.
//
// What bounds it on the H100: the lattice is a serial recurrence over ne
// lines per stream (up to 8 dependent multiply-add steps per line), so it is
// latency-bound; one frame offers no parallelism beyond its stream. Design:
// one thread per stream with the 8 lattice states in registers; lines are
// read and written in a [ne, S] layout (streams on the fast axis), so each
// warp touches 32 consecutive floats per line and every access coalesces.
//
// Exactness: compiled with --fmad=false, so each multiply and add rounds
// like the eager PyTorch ops of tns_analysis_plain.
#include <cuda_runtime.h>

namespace {

__global__ void tns_analysis_kernel(const float* __restrict__ x_t,
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
    const int last = ord - 1;  // 0..7
    float t = xv, st_save = xv;
    float ns[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float rc = in_f1 ? rc1[k] : rc0[k];
      if (k < last) {
        const float st_tmp = rc * t + st[k];
        t = t + rc * st[k];
        ns[k] = st_save;
        st_save = st_tmp;
      } else if (k == last) {
        t = t + rc * st[k];
        ns[k] = st_save;
      } else {
        ns[k] = st[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = ns[k];
    out_t[(size_t)n * S + s] = t;
  }
}

}  // namespace

// x_t, out_t: [ne, S] f32; rc_q: [S, 16] f32; bounds: [S, 4] i32 (lo0, hi0,
// lo1, hi1); order: [S, 2] i32 (the second already gated by num_filters).
extern "C" int lc3t_tns_analysis(const float* x_t, const float* rc_q, const int* bounds,
                                 const int* order, float* out_t, int S, int ne,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  tns_analysis_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x_t, rc_q, bounds, order, out_t, S, ne);
  return static_cast<int>(cudaGetLastError());
}
