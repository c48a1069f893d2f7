// Decoder LTPF synthesis: both filter passes of one frame.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_ltpf.py:_ltpf_kernel (entry
// ltpf_both_passes_pallas); semantics of the blocked IIR in
// lc3jax/dsp/ltpf.py (_blocked_filter_pass, _blocked_filter_pass_perstream).
//
//   y[n] = base[n] - fade[n] * (num[n] - den[n])
//   num[n] = sum_k c_num[k] * src[H + n - k]           (k = 0..l_num)
//   den[n] = sum_k c_den[k] * ycat[H + n - rb + off + l_den - k]
//   off = clamp(rb - p_int - ceil(l_den / 2), 0, rb)
//
// Pass A (fade-out, previous coefficients) reads the input; pass B (new
// coefficients) reads, per output sample, either the input or the case-5
// scratch (the last l_num history samples followed by pass A's output).
//
// What bounds it on the H100: the denominator feeds the output back, so
// each stream is a serial chain of nf / B blocks per pass, and only the
// B <= 16 samples of one block are independent (the nearest denominator tap
// lies at least 18 samples back at every rate). The arithmetic is small
// (2 x nf x (l_num + l_den + 2) multiply-adds a stream, about 23k at
// 48 kHz) and the bytes are about 15 KB a stream, so the time is the
// chain's latency (2 x nf / B steps of one short fold) times the number of
// streams an SM must run one after another, plus the latency of loading
// each stream's inputs.
//
// Design: a half-warp per stream, eight streams per 128-thread block (256
// blocks at S = 2048, all resident at once on the 132 SMs). Lane b computes
// sample b of the current block; with B = 15 lane 15 idles. Everything a
// stream touches during the chain sits in shared memory, loaded once and
// coalesced from the inputs' own [S, len] rows:
//   - the working row: the last rb history outputs (the lowest index a
//     denominator tap reaches is H - rb), then the pass's nf outputs, then
//     l_den zeros;
//   - the input window xcat[H - l_num, H + nf);
//   - the case-5 scratch (hist_y[H - l_num, H), then pass A's output);
//   - pass B's fade and scratch selection; pass A's fade (shared by the
//     block's streams).
// At 48 kHz / 10 ms that is 11.7 KB a stream, 94 KB a block (two blocks an
// SM). The offsets come from p_int here, and the outputs are written as
// [S, nf] rows, so the wrapper issues this one launch and nothing else.
// Each block's B outputs are computed from the row as it stood before the
// block, the half-warp syncs, then they are written, exactly like the
// vectorised block of the JAX scan: positions at or past the write cursor
// are read as the zeros each pass starts from (they are reachable only
// through zero coefficients for a real pitch lag).
//
// Exactness: every FIR is a left fold over k = 0..l of separately rounded
// products (compiled with --fmad=false) inside one thread, the same order
// as ltpf_both_passes_plain and pallas_ltpf.py:67-71, so kernel and plain
// version agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;           // one half-warp per stream
constexpr int kStreamsPerBlock = 8;  // 128 threads
constexpr int kMaxB = 16;
constexpr int kMaxTaps = 13;  // l_den <= 12 (48 kHz), l_num = l_den - 2

struct Geometry {
  int H, nf, B, l_num, l_den, rb;
  __host__ __device__ int rowlen() const { return rb + nf + l_den; }
  __host__ __device__ int wlen() const { return l_num + nf; }
  // floats of one stream's slot: row, input window, scratch, fade, then the
  // selection bytes rounded up to whole floats
  __host__ __device__ int slot_floats() const { return rowlen() + 2 * wlen() + nf + (nf + 3) / 4; }
};

__global__ void __launch_bounds__(kLanes * kStreamsPerBlock) ltpf_kernel(
    const float* __restrict__ xcat, const float* __restrict__ hist_y,
    const float* __restrict__ c_num_a, const float* __restrict__ c_den_a,
    const int* __restrict__ p_int_a, const float* __restrict__ c_num_b,
    const float* __restrict__ c_den_b, const int* __restrict__ p_int_b,
    const float* __restrict__ fade_down, const float* __restrict__ fadeB,
    const uint8_t* __restrict__ use_scratch, float* __restrict__ ya,
    float* __restrict__ yb, int S, Geometry g) {
  extern __shared__ float smem[];
  const int H = g.H, nf = g.nf, B = g.B, l_num = g.l_num, l_den = g.l_den, rb = g.rb;
  float* fd = smem;  // pass A's fade, shared by the block's streams
  for (int i = threadIdx.x; i < nf; i += blockDim.x) fd[i] = fade_down[i];
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  const int s = blockIdx.x * kStreamsPerBlock + slot;
  if (s >= S) return;  // the whole half-warp leaves together
  const unsigned mask = 0xffffu << (threadIdx.x & 16);  // this half-warp's lanes
  const int rowlen = g.rowlen(), wlen = g.wlen();
  float* row = fd + nf + slot * g.slot_floats();  // ycat[H - rb, H + nf + l_den)
  float* xw = row + rowlen;                         // xcat[H - l_num, H + nf)
  float* scr = xw + wlen;                           // the case-5 scratch
  float* fb = scr + wlen;                           // pass B's fade
  uint8_t* sel = reinterpret_cast<uint8_t*>(fb + nf);  // pass B's scratch selection

  const float* hs = hist_y + (size_t)s * H + (H - rb);
  const float* xs = xcat + (size_t)s * (H + nf) + (H - l_num);
  const float* fbs = fadeB + (size_t)s * nf;
  const uint8_t* sls = use_scratch + (size_t)s * nf;
#pragma unroll 8
  for (int i = lane; i < rb; i += kLanes) row[i] = hs[i];
#pragma unroll 8
  for (int i = lane; i < wlen; i += kLanes) xw[i] = xs[i];
#pragma unroll 8
  for (int i = lane; i < nf; i += kLanes) {
    fb[i] = fbs[i];
    sel[i] = sls[i];
  }
  for (int i = lane; i < l_num; i += kLanes) scr[i] = hs[rb - l_num + i];

  const int ceil_half = l_den - l_den / 2;
  for (int pass = 0; pass < 2; ++pass) {
    const float* c_num = (pass == 0 ? c_num_a : c_num_b) + (size_t)s * (l_num + 1);
    const float* c_den = (pass == 0 ? c_den_a : c_den_b) + (size_t)s * (l_den + 1);
    const int p_int = pass == 0 ? p_int_a[s] : p_int_b[s];
    const int off = min(max(rb - p_int - ceil_half, 0), rb);
    float cn[kMaxTaps], cd[kMaxTaps];
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      cn[k] = k <= l_num ? c_num[k] : 0.0f;
      cd[k] = k <= l_den ? c_den[k] : 0.0f;
    }
    for (int i = rb + lane; i < rowlen; i += kLanes) row[i] = 0.0f;
    __syncwarp(mask);

    const float* fade = pass == 0 ? fd : fb;
    float* out = (pass == 0 ? ya : yb) + (size_t)s * nf;
    for (int n0 = 0; n0 < nf; n0 += B) {
      const int n = n0 + lane;
      const bool on = lane < B && n < nf;
      float y = 0.0f;
      if (on) {
        // numerator over the input, or over the case-5 scratch
        const float* xn = (pass == 1 && sel[n]) ? scr + l_num + n : xw + l_num + n;
        float num = cn[0] * xn[0];
#pragma unroll
        for (int k = 1; k < kMaxTaps; ++k)
          if (k <= l_num) num = num + cn[k] * xn[-k];
        const float* yn = row + n + off + l_den;  // ycat[H + n - rb + off + l_den]
        float den = cd[0] * yn[0];
#pragma unroll
        for (int k = 1; k < kMaxTaps; ++k)
          if (k <= l_den) den = den + cd[k] * yn[-k];
        y = xn[0] - fade[n] * (num - den);
      }
      __syncwarp(mask);  // every lane has read the row as it stood before the block
      if (on) {
        row[rb + n] = y;
        out[n] = y;
        if (pass == 0) scr[l_num + n] = y;
      }
      __syncwarp(mask);
    }
  }
}

}  // namespace

// All rows are C-contiguous [S, len]: xcat [S, H+nf]; hist_y [S, H];
// c_num_* [S, l_num+1]; c_den_* [S, l_den+1]; p_int_* [S] i32;
// fade_down [nf]; fadeB [S, nf]; use_scratch [S, nf] bool bytes;
// outputs ya, yb [S, nf]. One launch; the dynamic shared memory (94 KB at
// 48 kHz / 10 ms) is allowed above 48 KB on each call.
extern "C" int lc3t_ltpf_both_passes(
    const float* xcat, const float* hist_y, const float* c_num_a, const float* c_den_a,
    const int* p_int_a, const float* c_num_b, const float* c_den_b, const int* p_int_b,
    const float* fade_down, const float* fadeB, const uint8_t* use_scratch, float* ya,
    float* yb, int S, int H, int nf, int B, int l_num, int l_den, int rb, void* stream) {
  if (S < 1 || B < 1 || B > kMaxB || l_den + 1 > kMaxTaps || l_num > l_den || rb > H ||
      rb < l_num)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{H, nf, B, l_num, l_den, rb};
  const size_t smem = sizeof(float) * ((size_t)nf + (size_t)kStreamsPerBlock * g.slot_floats());
  cudaError_t err = cudaFuncSetAttribute(ltpf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kStreamsPerBlock - 1) / kStreamsPerBlock;
  ltpf_kernel<<<blocks, kLanes * kStreamsPerBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      xcat, hist_y, c_num_a, c_den_a, p_int_a, c_num_b, c_den_b, p_int_b, fade_down, fadeB,
      use_scratch, ya, yb, S, g);
  return static_cast<int>(cudaGetLastError());
}
