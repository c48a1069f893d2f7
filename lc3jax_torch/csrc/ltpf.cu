// Decoder LTPF synthesis: both filter passes of one frame.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_ltpf.py:_ltpf_kernel (entry
// ltpf_both_passes_pallas); semantics of the blocked IIR in
// lc3jax/dsp/ltpf.py (_blocked_filter_pass, _blocked_filter_pass_perstream).
//
//   y[n] = base[n] - fade[n] * (num[n] - den[n])
//   num[n] = sum_k c_num[k] * src[H + n - k]           (k = 0..l_num)
//   den[n] = sum_k c_den[k] * ycat[H + n - rb + off + l_den - k]
//
// Pass A (fade-out, previous coefficients) reads the input; pass B (new
// coefficients) reads, per output sample, either the input or the case-5
// scratch (the last l_num history samples followed by pass A's output).
//
// What bounds it on the H100: the denominator feeds the output back with a
// lag of at least 18 samples, so each stream is a serial chain of nf
// samples x (l_num + l_den + 2) multiply-adds per pass; there is no
// parallelism inside a stream beyond the 16-sample block the lag allows.
// Design: one thread per stream, looping over blocks of B samples in order.
// The working row ycat (H + nf + l_den floats) and the case-5 scratch
// (l_num + nf) live in wrapper-allocated global buffers in a [len, S]
// layout (streams on the fast axis), as do the inputs, so a warp's loads of
// one sample index are coalesced; at S = 2048 the buffers take a few MB and
// stay in the 50 MB L2. Each block's B outputs are computed from the buffer
// as it stood before the block and written afterwards, exactly like the
// vectorised block of the JAX scan, so positions at or past the write
// cursor are read as the zeros each pass starts from (they are reachable
// only through zero coefficients for a real pitch lag).
//
// Exactness: every FIR is a left fold over k = 0..l of separately rounded
// products (compiled with --fmad=false), the same order as
// ltpf_both_passes_plain and pallas_ltpf.py:67-71, so kernel and plain
// version agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 16;
constexpr int kMaxTaps = 13;  // l_den <= 12 (48 kHz), l_num = l_den - 2

__global__ void ltpf_kernel(
    const float* __restrict__ xcat_t, const float* __restrict__ hist_y_t,
    const float* __restrict__ c_num_a, const float* __restrict__ c_den_a,
    const int* __restrict__ off_a, const float* __restrict__ c_num_b,
    const float* __restrict__ c_den_b, const int* __restrict__ off_b,
    const float* __restrict__ fade_down, const float* __restrict__ fadeB_t,
    const int* __restrict__ use_scratch_t, float* __restrict__ ycat_t,
    float* __restrict__ sbuf_t, float* __restrict__ ya_t, float* __restrict__ yb_t,
    int S, int H, int nf, int B, int l_num, int l_den, int rb) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int nblocks = nf / B;
  const int ylen = H + nf + l_den;
  auto X = [&](int i) { return xcat_t[(size_t)i * S + s]; };
  auto Y = [&](int i) -> float& { return ycat_t[(size_t)i * S + s]; };
  auto SB = [&](int i) -> float& { return sbuf_t[(size_t)i * S + s]; };

  float cn[kMaxTaps], cd[kMaxTaps];
  for (int i = 0; i < H; ++i) Y(i) = hist_y_t[(size_t)i * S + s];

  for (int pass = 0; pass < 2; ++pass) {
    const float* c_num = pass == 0 ? c_num_a : c_num_b;
    const float* c_den = pass == 0 ? c_den_a : c_den_b;
    const int off = pass == 0 ? off_a[s] : off_b[s];
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      cn[k] = k <= l_num ? c_num[(size_t)s * (l_num + 1) + k] : 0.0f;
      cd[k] = k <= l_den ? c_den[(size_t)s * (l_den + 1) + k] : 0.0f;
    }
    for (int i = H; i < ylen; ++i) Y(i) = 0.0f;
    const int dbase = -rb + off + l_den;  // den tap k reads ycat[q + b + dbase - k]

    for (int bi = 0; bi < nblocks; ++bi) {
      const int q = H + bi * B;
      float yblk[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b >= B) break;
        const int n = bi * B + b;
        const bool scr = pass == 1 && use_scratch_t[(size_t)n * S + s] != 0;
        // numerator over the input, or over the case-5 scratch
        float num = cn[0] * (scr ? SB(l_num + n) : X(q + b));
#pragma unroll
        for (int k = 1; k < kMaxTaps; ++k)
          if (k <= l_num) num = num + cn[k] * (scr ? SB(l_num + n - k) : X(q + b - k));
        float den = cd[0] * Y(q + b + dbase);
#pragma unroll
        for (int k = 1; k < kMaxTaps; ++k)
          if (k <= l_den) den = den + cd[k] * Y(q + b + dbase - k);
        const float base = scr ? SB(l_num + n) : X(q + b);
        const float fade = pass == 0 ? fade_down[n] : fadeB_t[(size_t)n * S + s];
        yblk[b] = base - fade * (num - den);
      }
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b >= B) break;
        Y(q + b) = yblk[b];
      }
    }

    float* out = pass == 0 ? ya_t : yb_t;
    for (int n = 0; n < nf; ++n) out[(size_t)n * S + s] = Y(H + n);
    if (pass == 0) {
      for (int i = 0; i < l_num; ++i) SB(i) = hist_y_t[(size_t)(H - l_num + i) * S + s];
      for (int n = 0; n < nf; ++n) SB(l_num + n) = Y(H + n);
    }
  }
}

}  // namespace

// xcat_t [H+nf, S]; hist_y_t [H, S]; c_num_* [S, l_num+1]; c_den_* [S, l_den+1];
// off_* [S] i32; fade_down [nf]; fadeB_t [nf, S]; use_scratch_t [nf, S] i32;
// scratch ycat_t [H+nf+l_den, S], sbuf_t [l_num+nf, S]; outputs ya_t, yb_t [nf, S].
extern "C" int lc3t_ltpf_both_passes(
    const float* xcat_t, const float* hist_y_t, const float* c_num_a,
    const float* c_den_a, const int* off_a, const float* c_num_b,
    const float* c_den_b, const int* off_b, const float* fade_down,
    const float* fadeB_t, const int* use_scratch_t, float* ycat_t, float* sbuf_t,
    float* ya_t, float* yb_t, int S, int H, int nf, int B, int l_num, int l_den,
    int rb, void* stream) {
  if (B > kMaxB || l_den + 1 > kMaxTaps || l_num > l_den) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  ltpf_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      xcat_t, hist_y_t, c_num_a, c_den_a, off_a, c_num_b, c_den_b, off_b, fade_down,
      fadeB_t, use_scratch_t, ycat_t, sbuf_t, ya_t, yb_t, S, H, nf, B, l_num, l_den, rb);
  return static_cast<int>(cudaGetLastError());
}
