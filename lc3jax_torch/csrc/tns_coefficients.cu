// Encoder TNS coefficients: for each stream and filter, the lag-0..8 sums of
// its 3 sub-blocks, the normalised and lag-windowed autocorrelation,
// Levinson-Durbin, the prediction-gain gate, the LPC weighting, the inverse
// recursion to reflection coefficients, their quantisation and the bit
// budget: all of the TNS stage but the lattice (csrc/tns_analysis.cu).
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_tns.py:_autocorr_kernel
// (entry tns_autocorr_pallas) and the XLA glue that consumes its sums
// (lc3jax/dsp/encoder.py:705-871), which XLA fused into the jitted step on
// the TPU; eager PyTorch ran that glue as about 900 kernels of a few µs over
// [S] vectors. Semantics: dsp/tns_enc_kernel.py:tns_coefficients_plain, op
// for op; the oracle is lc3jax/ref/tns_enc.py:60-200. Each lag sum is the
// oracle's strict left-to-right f32 fold (ref/tns_enc.py:_autocorrelation):
// the Pallas and XLA versions reduce with jnp.sum in XLA's order, the port
// pins the oracle's, so each sum stays in one lane.
//
// What bounds it on the H100: the bytes are x (1.6 KB a stream at
// 48 kHz / 10 ms, 3.3 MB at S = 2048, about 1 µs) and a few hundred bytes
// of outputs a stream; the arithmetic is small. What is left is latency:
// per (stream, filter) a fold of up to 67 dependent adds, then a scalar
// recursion of about 40 dependent divisions (Levinson-Durbin and its
// inverse) and an asin in f64. Measured (H100 80GB HBM3 at 700 W, S =
// 2048): 0.0108 ms on the device (chip_smoke.py phase 9); per (stream,
// filter) warp the lag folds take about 1,800 cycles alone and 6,500 at
// S = 2048, where 64 warps an SM issue their loads and adds in turn, and
// the epilogue about 4,300 alone (tools/kernel_phases.py --kernels
// coefficients).
//
// Design: two warps a stream, one a filter; 4 streams (256 threads) a
// block, so at S = 2048 all 512 blocks are resident at once. The block
// stages its streams' rows of x in shared memory (cp.async, 16 bytes at a
// time) while each lane loads its stream's sub-block bounds from the
// bandwidth itself. Lanes 0-26 fold one (sub-block, lag) each, four lines a
// step with the step's loads and products ahead of its dependent adds.
// Then lane k < 9 normalises lag k across the three sub-blocks, in the
// plain version's order ((q0 + q1) + q2) * lag_window[k], every lane
// gathers the nine values, and every lane runs the same scalar recursion on
// the same values (no broadcast afterwards); lane k < 8 quantises
// coefficient k, the order is the highest lane of a ballot, the bits a sum
// of shuffles (integers, in any order); the two warps of a stream add their
// bits through shared memory.
//
// Exactness: compiled with --fmad=false, so each multiply and add rounds
// like the plain version's eager ops; every division is a true IEEE
// division (__fdiv_rn), as PyTorch divides one tensor by another; /0.5
// and /2048 are exact either way. asin is the f64 libdevice function that
// torch.asin runs on the card for an f64 tensor, rounded once to f32.
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kStreams = 4;  // streams a block stages, two warps each
constexpr int kThreads = 64 * kStreams;
constexpr unsigned kFull = 0xffffffffu;

// f32 x^n by binary exponentiation (LLVM powi), as tns_enc_kernel._powi.
__device__ __forceinline__ float powi(float x, int n) {
  float result = 1.0f, base = x;
  while (n > 0) {
    if (n & 1) result = result * base;
    base = base * base;
    n >>= 1;
  }
  return result;
}

// sum over n in [lo, end) of xr[n] * xr[n + k], left to right
__device__ __forceinline__ float lag_fold(const float* xr, int lo, int end, int k) {
  float acc = 0.0f;
  int n = lo;
  for (; n + 4 <= end; n += 4) {
    const float p0 = xr[n] * xr[n + k], p1 = xr[n + 1] * xr[n + 1 + k];
    const float p2 = xr[n + 2] * xr[n + 2 + k], p3 = xr[n + 3] * xr[n + 3 + k];
    acc = acc + p0;
    acc = acc + p1;
    acc = acc + p2;
    acc = acc + p3;
  }
  for (; n < end; ++n) acc = acc + xr[n] * xr[n + k];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
tns_coefficients_kernel(const float* __restrict__ x, const int* __restrict__ bw_ind,
                        const unsigned char* __restrict__ near_nyquist,
                        const int* __restrict__ tns_sub, const float* __restrict__ lag_window,
                        const float* __restrict__ tns_sin, const int* __restrict__ tns_bits,
                        const float* __restrict__ tns_step, float* __restrict__ ac,
                        int* __restrict__ rc_i, float* __restrict__ rc_q,
                        int* __restrict__ rc_order, int* __restrict__ nbits_tns, int S, int ne,
                        int row, int lpc_weighting) {
  extern __shared__ __align__(16) float xs[];  // [kStreams][row]
  __shared__ int s_bits[kStreams][2];
  const int s0 = blockIdx.x * kStreams;
  const int nvalid = min(kStreams, S - s0);
  lc3t::stage_rows<kThreads>(xs, row, x + (size_t)s0 * ne, ne, nvalid);

  const int lane = threadIdx.x & 31;
  const int u = threadIdx.x >> 6;  // the warp's stream in the block
  const int f = (threadIdx.x >> 5) & 1;  // and its filter
  const int s = s0 + u;
  const int b = lane / 9, k = lane - 9 * b;  // the lane's (sub-block, lag), lanes 0-26
  int lo = 0, end = 0, nf = 1;
  bool nn = false;
  if (u < nvalid) {
    const int bw = min(max(bw_ind[s], 0), 4);
    nf = bw >= 3 ? 2 : 1;
    nn = near_nyquist[s] != 0;
    if (lane < 27) {
      const int* sb = tns_sub + ((bw * 2 + f) * 3 + b) * 2;
      const int hi = min(sb[1], ne);  // a bound past ne stops at ne
      lo = min(sb[0], hi);
      end = max(hi - k, lo);
    }
  }
  const float lw = lag_window[min(lane, 8)];
  const float step = *tns_step;
  lc3t::wait_async_copies();
  __syncthreads();

  if (u < nvalid) {  // uniform over the warp
    // ---- the lag sums
    const float acc = lag_fold(xs + u * row, lo, end, k);
    if (lane < 27) ac[(size_t)s * 54 + f * 27 + lane] = acc;

    // ---- normalisation and lag window: lane kk holds r[kk]
    const int kk = min(lane, 8);
    const float es0 = __shfl_sync(kFull, acc, 0), es1 = __shfl_sync(kFull, acc, 9);
    const float es2 = __shfl_sync(kFull, acc, 18);
    const float c0 = __shfl_sync(kFull, acc, kk), c1 = __shfl_sync(kFull, acc, 9 + kk);
    const float c2 = __shfl_sync(kFull, acc, 18 + kk);
    const float e_prod = (es0 * es1) * es2;
    const float q0 = es0 != 0.0f ? __fdiv_rn(c0, es0) : 0.0f;
    const float q1 = es1 != 0.0f ? __fdiv_rn(c1, es1) : 0.0f;
    const float q2 = es2 != 0.0f ? __fdiv_rn(c2, es2) : 0.0f;
    const float rk = (q0 + q1) + q2;
    const float rv = (e_prod == 0.0f ? (kk == 0 ? 3.0f : 0.0f) : rk) * lw;
    float r[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) r[j] = __shfl_sync(kFull, rv, j);

    // ---- Levinson-Durbin (ref/tns_enc.py:161-176), in every lane
    float a[9];
    a[0] = 1.0f;
#pragma unroll
    for (int j = 1; j < 9; ++j) a[j] = 0.0f;
    float e = r[0];
#pragma unroll
    for (int m = 1; m < 9; ++m) {
      float rc = 0.0f;
#pragma unroll
      for (int n = 0; n < m; ++n) rc = rc - a[n] * r[m - n];
      if (e != 0.0f) rc = __fdiv_rn(rc, e);
      float na[9];
#pragma unroll
      for (int n = 1; n < m; ++n) na[n] = a[n] + rc * a[m - n];
#pragma unroll
      for (int n = 1; n < m; ++n) a[n] = na[n];
      a[m] = rc;
      e = e * (1.0f - rc * rc);
    }

    // ---- the gate and the weighting
    const float pred_gain = e == 0.0f ? r[0] : __fdiv_rn(r[0], e);
    const bool on = pred_gain > 1.5f && !nn;
    const float c085 = 1.0f - 0.85f;
    const float gamma = (lpc_weighting > 0 && pred_gain < 2.0f)
                            ? 1.0f - __fdiv_rn(c085 * (2.0f - pred_gain), 0.5f)
                            : 1.0f;
#pragma unroll
    for (int j = 0; j < 9; ++j) a[j] = a[j] * powi(gamma, j);

    // ---- LPC -> reflection coefficients (the inverse recursion)
    float rcf[8];
#pragma unroll
    for (int m = 8; m > 0; --m) {
      const float rcm = a[m];
      rcf[m - 1] = rcm;
      const float ee = 1.0f - rcm * rcm;
      float na[9];
#pragma unroll
      for (int n = 1; n < m; ++n) na[n] = __fdiv_rn(a[n] - rcm * a[m - n], ee);
#pragma unroll
      for (int n = 1; n < m; ++n) a[n] = na[n];
    }

    // ---- quantisation: lane j < 8 takes coefficient j
    float mine = rcf[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) mine = lane == j ? rcf[j] : mine;
    if (!on) mine = 0.0f;
    const float q = __fdiv_rn(static_cast<float>(asin(static_cast<double>(mine))), step);
    const long long qi = q >= 0.0f ? static_cast<long long>(q + 0.5f)
                                   : -static_cast<long long>(-q + 0.5f);
    const int ri = static_cast<int>(qi + 8);
    const int ric = min(max(ri, 0), 16);
    const unsigned nz = __ballot_sync(kFull, lane < 8 && ri != 8);
    const int order = 32 - __clz(nz);  // the highest k with rc_i != 8, plus one; 0 if none
    int bits = lane < order ? tns_bits[16 + 17 * lane + ric] : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(kFull, bits, d);
    const int nb_order = order > 0 ? tns_bits[8 * lpc_weighting + order - 1] : 0;
    const int add = static_cast<int>(
        ceilf(((2048.0f + static_cast<float>(nb_order)) + static_cast<float>(bits)) / 2048.0f));
    const bool exists = f < nf;
    if (lane < 8) {
      rc_i[(size_t)s * 16 + 8 * f + lane] = exists ? ri : 8;
      rc_q[(size_t)s * 16 + 8 * f + lane] = exists ? tns_sin[ric] : 0.0f;
    }
    if (lane == 0) {
      rc_order[2 * s + f] = exists ? order : 0;
      s_bits[u][f] = exists ? add : 0;
    }
  }
  __syncthreads();
  if (threadIdx.x < nvalid) nbits_tns[s0 + threadIdx.x] = s_bits[threadIdx.x][0] + s_bits[threadIdx.x][1];
}

}  // namespace

// x: [S, ne] f32; bw_ind: [S] i32; near_nyquist: [S] bool (one byte each);
// tns_sub: [5, 2, 3, 2] i32 (lo, hi per bandwidth, filter, sub-block);
// lag_window: [9] f32; tns_sin: [17] f32; tns_bits: [2 * 8 + 8 * 17] i32
// (the order bits by lpc_weighting, then the coefficient bits by k);
// tns_step: [1] f32. Outputs: ac [S, 2, 3, 9] f32, rc_i [S, 16] i32, rc_q
// [S, 16] f32, rc_order [S, 2] i32, nbits_tns [S] i32.
extern "C" int lc3t_tns_coefficients(const float* x, const int* bw_ind,
                                     const unsigned char* near_nyquist, const int* tns_sub,
                                     const float* lag_window, const float* tns_sin,
                                     const int* tns_bits, const float* tns_step, float* ac,
                                     int* rc_i, float* rc_q, int* rc_order, int* nbits_tns, int S,
                                     int ne, int lpc_weighting, void* stream) {
  const int row = (ne + 3) & ~3;  // a multiple of 4: 16-byte staging
  const size_t smem = sizeof(float) * kStreams * row;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);  // ne <= 400 needs 6.4 KB
  const int blocks = (S + kStreams - 1) / kStreams;
  tns_coefficients_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, bw_ind, near_nyquist, tns_sub, lag_window, tns_sin, tns_bits, tns_step, ac, rc_i, rc_q,
      rc_order, nbits_tns, S, ne, row, lpc_weighting);
  return static_cast<int>(cudaGetLastError());
}
