// Inverse TNS (decoder): the 8-tap IIR lattice over spectral lines, up to
// two filters per frame.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_tns.py:_tns_kernel (entry
// tns_synthesis_pallas); semantics of lc3jax/dsp/decoder.py:tns_synthesis.
//
// What bounds it on the H100: the lattice is IIR (each line's output feeds
// every state the next line reads), so each stream is one serial chain over
// its active lines (up to 388 at 48 kHz / 10 ms): about 30 operations a
// line, 5 of them dependent from one line to the next; the bytes (2 x S x ne
// floats) take about 2 µs. So the chain's latency sets the time, and
// everything else is kept off it. Design: a block stages kStreams rows of x
// in shared memory (cp.async, 16 bytes at a time) while each lane loads its
// stream's filter bounds and reflection coefficients itself, from the
// bandwidth, rc_i and the two small tables; then one lane a stream runs the
// lattice with the 8 states and the filter's coefficients in registers, in
// blocks of kLines lines whose x is loaded while the block before computes,
// each output written over its x in shared memory; the block stores the
// rows out 16 bytes at a time. Lines run as segments of one filter each,
// with that filter's coefficients and order fixed: no per-tap choice of
// filter, and no per-tap test of the order (the coefficients above it are
// zero). At S = 2048 that is 128 blocks, one a streaming multiprocessor.
//
// Exactness: the state update follows _tns_kernel (pallas_tns.py:46-68):
// lattice rows change only on active lines, the pass-through line is copied.
// The library is compiled with --fmad=false, so each multiply and subtract
// rounds like the eager PyTorch ops of tns_synthesis_plain, which also
// subtracts a zero coefficient's product for a tap above the order (the
// result may differ from skipping the tap only in the sign of a zero).
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kStreams = 16;  // streams a block stages, one lane each
constexpr int kThreads = 128;
constexpr int kLines = 8;  // lines a block of the chain loads ahead

// One line of the IIR lattice: t enters as x and leaves as the output; st
// carried. rc holds the filter's coefficients below its order and zeros
// above it, so every line runs all 8 taps with no test: a tap above the
// order subtracts an exact zero, as tns_synthesis_plain does, and shifts a
// state that no tap of this filter reads (taps at or above the order), which
// the caller puts back when the filter ends.
__device__ __forceinline__ void line(float& t, const float (&rc)[8], float (&st)[8]) {
#pragma unroll
  for (int kk = 7; kk >= 0; --kk) {
    t = t - rc[kk] * st[kk];
    if (kk < 7) st[kk + 1] = rc[kk] * t + st[kk];
  }
  st[0] = t;
}

// The lattice over lines [n, end) of one filter, in place in the staged row
// xs. Lines go in blocks of kLines, whose x is loaded while the block
// before computes (reading up to kLines - 1 floats past end: the row's
// padding or lines of a later segment, unused); within a block the
// compiler interleaves a line's last taps with the next line's first.
__device__ __forceinline__ void lattice(float* xs, int n, int end, const float (&rc)[8],
                                        float (&st)[8]) {
  float cur[kLines];
#pragma unroll
  for (int i = 0; i < kLines; ++i) cur[i] = xs[n + i];
  for (; n + kLines <= end; n += kLines) {
    float next[kLines];
#pragma unroll
    for (int i = 0; i < kLines; ++i) next[i] = xs[n + kLines + i];
#pragma unroll
    for (int i = 0; i < kLines; ++i) {
      line(cur[i], rc, st);
      xs[n + i] = cur[i];
      cur[i] = next[i];
    }
  }
  for (; n < end; ++n) {
    float t = xs[n];
    line(t, rc, st);
    xs[n] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
tns_synthesis_kernel(const float* __restrict__ x, const int* __restrict__ bandwidth,
                     const int* __restrict__ rc_order, const int* __restrict__ rc_i,
                     const int* __restrict__ tns_bounds, const float* __restrict__ tns_sin,
                     float* __restrict__ y, int S, int ne, int row) {
  extern __shared__ __align__(16) float xs[];  // [kStreams][row]
  const int s0 = blockIdx.x * kStreams;
  const int nvalid = min(kStreams, S - s0);
  const int tid = threadIdx.x;
  lc3t::stage_rows<kThreads>(xs, row, x + (size_t)s0 * ne, ne, nvalid);

  // the lane's stream's filters and coefficients, loaded while the rows arrive
  int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0, ord0 = 0, ord1 = 0;
  float rcv[16];
  if (tid < nvalid) {
    const int s = s0 + tid;
    const int bw = min(max(bandwidth[s], 0), 4);
    lo0 = tns_bounds[4 * bw + 0];
    hi0 = min(tns_bounds[4 * bw + 1], ne);
    lo1 = tns_bounds[4 * bw + 2];
    hi1 = min(tns_bounds[4 * bw + 3], ne);
    ord0 = rc_order[2 * s + 0];
    ord1 = rc_order[2 * s + 1];
    if (ord0 <= 0 || lo0 > hi0) lo0 = hi0;  // empty: the filter is off or past ne
    if (ord1 <= 0 || lo1 > hi1) lo1 = hi1;
#pragma unroll
    for (int k = 0; k < 16; ++k) rcv[k] = tns_sin[min(max(rc_i[16 * s + k], 0), 16)];
  }
  lc3t::wait_async_copies();
  __syncthreads();

  if (tid < nvalid) {
    float* row_s = xs + tid * row;
    float st[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = 0.0f;
    int n = min(lo0, lo1);
    const int stop = max(hi0, hi1);
    while (n < stop) {
      int end, ord;
      bool f1;
      if (n >= lo1 && n < hi1) {
        end = hi1;
        ord = ord1;
        f1 = true;
      } else if (n >= lo0 && n < hi0) {
        end = (lo1 < hi1 && lo1 > n) ? min(hi0, lo1) : hi0;
        ord = ord0;
        f1 = false;
      } else {  // between the filters: x passes through, the state is held
        end = stop;
        if (lo0 < hi0 && lo0 > n) end = min(end, lo0);
        if (lo1 < hi1 && lo1 > n) end = min(end, lo1);
        n = end;
        continue;
      }
      float rc[8], held[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        rc[k] = k < ord ? (f1 ? rcv[8 + k] : rcv[k]) : 0.0f;
        held[k] = st[k];
      }
      lattice(row_s, n, end, rc, st);
#pragma unroll
      for (int k = 1; k < 8; ++k) st[k] = k < ord ? st[k] : held[k];  // taps the filter holds
      n = end;
    }
  }
  __syncthreads();

  lc3t::store_rows<kThreads>(y + (size_t)s0 * ne, xs, row, ne, nvalid);
}

}  // namespace

// x, y: [S, ne] f32, C-contiguous; bandwidth: [S] i32; rc_order: [S, 2]
// i32; rc_i: [S, 16] i32 (indices into tns_sin); tns_bounds: [5, 4] i32
// (lo0, hi0, lo1, hi1 per bandwidth); tns_sin: [17] f32.
extern "C" int lc3t_tns_synthesis(const float* x, const int* bandwidth, const int* rc_order,
                                  const int* rc_i, const int* tns_bounds, const float* tns_sin,
                                  float* y, int S, int ne, void* stream) {
  // ne + kLines floats or more (the chain's loads ahead), a multiple of 4
  // (16-byte staging) with row / 4 odd: where the 16 lanes read one line
  // they fall on 8 banks, two lanes a bank
  const int row = ((ne + kLines + 3) & ~7) + 4;
  const size_t smem = sizeof(float) * kStreams * row;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);  // ne <= 400 needs 26 KB
  const int blocks = (S + kStreams - 1) / kStreams;
  tns_synthesis_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, bandwidth, rc_order, rc_i, tns_bounds, tns_sin, y, S, ne, row);
  return static_cast<int>(cudaGetLastError());
}
