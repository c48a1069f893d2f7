// SNS stage 2 (encoder): the greedy PVQ pyramid (6 + 2 + 10 unit-pulse
// rounds), the set-B pulse, unit-energy normalisation of the four shapes
// and the 14-candidate shape/gain search, for each stream's rotated
// residual t2rot[16].
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_sns.py:_kernel (entry
// sns_pvq_pallas); semantics of the XLA path of
// lc3jax/dsp/encoder.py:sns_analysis (:453-569), line by line: sequential
// f32 folds, strict `>` comparisons where the first lane wins ties, and the
// reference's scan-artifact accumulators carried between rounds.
//
// What bounds it on the H100: about 330 dependent compare-and-select steps
// per stream over 16 lanes held in registers; 64 B in and 140 B out per
// stream, so neither bytes nor flops bound it, but the serial chain of one
// thread does. Design: one thread per stream, all 16 lanes of every
// candidate in registers (fully unrolled loops, so the lane index is
// static), no shared memory. S = 2048 is 16 blocks of 128 threads.
//
// Exactness: compiled with --fmad=false, so every product rounds before the
// add that consumes it, like the eager PyTorch ops of sns_pvq_plain.
#include <cuda_runtime.h>

namespace {

struct Acc {
  float corr_l, energy_l, corr_art, energy_art;
};

// One greedy round over the first n_active lanes (n_active is 16 or 10).
template <int NACT>
__device__ __forceinline__ void greedy(int (&y)[16], const float (&ax)[16], Acc& a,
                                       bool need) {
  float cand_corr[16], cand_en[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    cand_corr[n] = a.corr_l + ax[n];
    cand_en[n] = (a.energy_l + 2.0f * (float)y[n]) + 1.0f;
  }
  int n_best = 0;
  float best_sq = cand_corr[0] * cand_corr[0];
  float best_en = cand_en[0];
#pragma unroll
  for (int lane = 1; lane < NACT; ++lane) {
    const float sq = cand_corr[lane] * cand_corr[lane];
    if (sq * best_en > best_sq * cand_en[lane]) {
      n_best = lane;
      best_sq = sq;
      best_en = cand_en[lane];
    }
  }
  if (!need) return;
  float best_abs = ax[0], best_y = (float)y[0];
#pragma unroll
  for (int n = 1; n < 16; ++n)
    if (n == n_best) {
      best_abs = ax[n];
      best_y = (float)y[n];
    }
  a.corr_l = a.corr_l + best_abs;
  a.energy_l = (a.energy_l + 2.0f * best_y) + 1.0f;
  a.corr_art = cand_corr[NACT - 1];
  a.energy_art = cand_en[NACT - 1];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    if (n == n_best) y[n] += 1;
}

template <int NACT>
__device__ __forceinline__ void normalize(const int (&y)[16], float (&xq)[16]) {
  float yf[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) yf[n] = n < NACT ? (float)y[n] : 0.0f;
  float acc = yf[0] * yf[0];
#pragma unroll
  for (int n = 1; n < 16; ++n) acc = acc + yf[n] * yf[n];
  const float norm = sqrtf(acc);
#pragma unroll
  for (int n = 0; n < 16; ++n) xq[n] = yf[n] != 0.0f ? yf[n] / norm : yf[n];
}

__global__ void sns_pvq_kernel(const float* __restrict__ t2rot, int* __restrict__ y_sel,
                               int* __restrict__ y0s, float* __restrict__ xq_sel,
                               int* __restrict__ shape_j_out, int* __restrict__ gind_out,
                               float* __restrict__ g_sel_out,
                               const float* __restrict__ gains, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float x[16], ax[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    x[n] = t2rot[16 * s + n];
    ax[n] = fabsf(x[n]);
  }
  float abs_sum = ax[0];
#pragma unroll
  for (int n = 1; n < 16; ++n) abs_sum = abs_sum + ax[n];
  const float proj = 5.0f / abs_sum;
  int y3[16];
  int k0 = 0;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    y3[n] = (int)floorf(ax[n] * proj);
    k0 += y3[n];
  }
  float corr = (float)y3[0] * ax[0], energy = (float)y3[0] * (float)y3[0];
#pragma unroll
  for (int n = 1; n < 16; ++n) {
    corr = corr + (float)y3[n] * ax[n];
    energy = energy + (float)y3[n] * (float)y3[n];
  }

  // shape 3: K = 6 pulses
  Acc a{corr, energy, corr, energy};
  int count = k0;
  for (int r = 0; r < 6; ++r) {
    const bool need = count < 6;
    greedy<16>(y3, ax, a, need);
    if (need) ++count;
  }
  // shape 2: two more pulses from the artifact accumulators
  int y2[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) y2[n] = y3[n];
  a.corr_l = a.corr_art;
  a.energy_l = a.energy_art;
  for (int r = 0; r < 2; ++r) greedy<16>(y2, ax, a, true);

  // shape 1: strip set B, re-add pulses in set A up to K = 10
  int y1[16];
  int kb = 0;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    y1[n] = n < 10 ? y2[n] : 0;
    if (n >= 10) kb += y2[n];
  }
  a.corr_l = a.corr_art;
  a.energy_l = a.energy_art;
#pragma unroll
  for (int n = 10; n < 16; ++n) {
    const float v = (float)y2[n];
    if (v != 0.0f) {
      a.corr_l = a.corr_l - v * ax[n];
      a.energy_l = a.energy_l - v * v;
    }
  }
  count = 8 - kb;
  for (int r = 0; r < 10; ++r) {
    const bool need = count < 10;
    greedy<10>(y1, ax, a, need);
    if (need) ++count;
  }

  // shape 0: y1 plus one pulse at the largest |x| of set B (first wins)
  int nb_best = 10;
  float b_best = ax[10];
#pragma unroll
  for (int n = 11; n < 16; ++n)
    if (ax[n] > b_best) {
      nb_best = n;
      b_best = ax[n];
    }
  int y0[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) y0[n] = n == nb_best ? 1 : y1[n];

#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int sg = x[n] < 0.0f ? -1 : 1;
    y0[n] *= sg;
    y1[n] *= sg;
    y2[n] *= sg;
    y3[n] *= sg;
  }
  float xq0[16], xq1[16], xq2[16], xq3[16];
  normalize<16>(y0, xq0);
  normalize<10>(y1, xq1);
  normalize<16>(y2, xq2);
  normalize<16>(y3, xq3);

  // shape/gain search in the order j*8 + g, strict < (the first wins)
  float best_mse = 0.0f;
  int shape_j = 0, gind = 0;
  float g_sel = gains[0];
  bool first = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* xq = j == 0 ? xq0 : j == 1 ? xq1 : j == 2 ? xq2 : xq3;
    const int n_gains = j == 0 ? 1 : j == 3 ? 7 : 3;  // searched gains per shape
    for (int gi = 0; gi < n_gains; ++gi) {
      const float gv = gains[8 * j + gi];
      float mse = 0.0f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float d = x[n] - gv * xq[n];
        mse = n == 0 ? d * d : mse + d * d;
      }
      if (first || mse < best_mse) {
        best_mse = mse;
        shape_j = j;
        gind = gi;
        g_sel = gv;
        first = false;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) {  // per-lane selects keep every array in registers
    y_sel[16 * s + n] = shape_j == 0 ? y0[n] : shape_j == 1 ? y1[n] : shape_j == 2 ? y2[n] : y3[n];
    y0s[16 * s + n] = y0[n];
    xq_sel[16 * s + n] =
        shape_j == 0 ? xq0[n] : shape_j == 1 ? xq1[n] : shape_j == 2 ? xq2[n] : xq3[n];
  }
  shape_j_out[s] = shape_j;
  gind_out[s] = gind;
  g_sel_out[s] = g_sel;
}

}  // namespace

// t2rot, y_sel, y0s, xq_sel: [S, 16]; shape_j, gind, g_sel: [S]; gains: the
// searched gains per shape, [4, 8] zero-padded, on the device.
extern "C" int lc3t_sns_pvq(const float* t2rot, int* y_sel, int* y0s, float* xq_sel,
                            int* shape_j, int* gind, float* g_sel, const float* gains,
                            int S, void* stream) {
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  sns_pvq_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      t2rot, y_sel, y0s, xq_sel, shape_j, gind, g_sel, gains, S);
  return static_cast<int>(cudaGetLastError());
}
