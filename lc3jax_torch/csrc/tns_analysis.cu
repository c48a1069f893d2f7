// Encoder TNS analysis: the forward 8-tap lattice over spectral lines, up to
// two filters per frame.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_tns.py:_tns_enc_kernel
// (entry tns_analysis_pallas); semantics of the XLA scan at
// lc3jax/dsp/encoder.py:877-913, including its pick of the last tap
// (:900-908): the tap at order - 1 reads the state as it was before the
// line and is the only one that takes st_save.
//
// What bounds it on the H100: the bytes are 2 x S x ne floats (6.6 MB at
// S = 2048, about 2 µs), the arithmetic a few µs at the f32 rate; a serial
// walk over each stream's lines is latency, not work. The lattice is FIR: a
// line's output and new states come from its own x and the states, and no
// output feeds back, so the state before an active line is a function of x
// at the 8 active lines before it alone (state k holds a term k lines old; a
// tap above a line's order is held, and is read later only by a filter of
// higher order, which finds it still at its initial zero, as long as filter
// 0 does not resume after filter 1: LC3's bounds never do, and a stream
// whose bounds do is walked by one lane from its first line). So the active
// lines of a stream split into chunks that run in parallel, each after a
// warm-up of the 8 active lines before it from zero state: every value a
// chunk's outputs read is then computed by the same operations on the same
// operands as in one walk from the first line, and the result is that
// walk's bit for bit (tests/test_torch_tns_enc.py holds the chunked walk
// equal to the plain version).
//
// Design: a warp a stream, a lane a chunk. The block stages its streams' rows
// of x in shared memory (cp.async, 16 bytes at a time) and copies them to
// the output rows, so that lines outside both filters (bounds past ne
// included) pass through. Each stream's active lines are numbered in order
// over its segments (ranges of one filter: up to three where the filters
// overlap, filter 1 winning); lane l takes the numbers [l C, (l + 1) C), C
// odd so that the 32 lanes read distinct banks, and walks its warm-up and
// its chunk a piece of one segment at a time, with that filter's
// coefficients in registers and its order a template argument: no per-tap
// choice of filter or test of the order, and every lane of a warp runs the
// same code on the same filter but where its chunk crosses a segment's
// edge. The block stores the rows out 16 bytes at a time.
//
// Exactness: compiled with --fmad=false, so each multiply and add rounds
// like the eager PyTorch ops of tns_analysis_plain; the taps above a line's
// order are not computed, so none adds a zero.
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kStreams = 4;  // streams a block stages, a warp each
constexpr int kThreads = 32 * kStreams;
constexpr int kWarm = 8;  // active lines the state depends on

// A stream's active lines as three segments of one filter each, in line
// order, any of them empty: filter 0 before filter 1, filter 1, filter 0
// after filter 1 (filter 1 wins where the two overlap). Fixed slots, so
// that they stay in registers.
struct Segments {
  int start[3], end[3];
};

__device__ __forceinline__ Segments segments(int lo0, int hi0, int lo1, int hi1, int ord0,
                                             int ord1, int ne) {
  lo0 = max(lo0, 0);
  lo1 = max(lo1, 0);
  hi0 = min(hi0, ne);
  hi1 = min(hi1, ne);
  if (ord0 <= 0 || lo0 >= hi0) lo0 = hi0 = 0;   // filter 0 off: empty
  if (ord1 <= 0 || lo1 >= hi1) lo1 = hi1 = ne;  // filter 1 off: empty, past every line
  Segments g;
  g.start[0] = lo0;
  g.end[0] = max(lo0, min(hi0, lo1));
  g.start[1] = lo1;
  g.end[1] = hi1;
  g.start[2] = max(lo0, hi1);
  g.end[2] = max(g.start[2], hi0);
  return g;
}

// count lines of one filter of order LAST + 1 from line n, the state st
// carried; the outputs of the lines from the write_from-th on go to yu
// (the lines before warm the state). The order is a template argument, so
// a line computes only its LAST + 1 taps, with no test: the taps above it
// hold their state.
template <int LAST>
__device__ __forceinline__ void run(const float* xu, float* yu, int n, int count, int write_from,
                                    const float (&rc)[8], float (&st)[8]) {
  for (int i = 0; i < count; ++i, ++n) {
    const float xv = xu[n];
    float t = xv, st_save = xv;
#pragma unroll
    for (int k = 0; k < LAST; ++k) {  // the taps below the last: st_save's chain
      const float st_tmp = rc[k] * t + st[k];
      t = t + rc[k] * st[k];
      st[k] = st_save;
      st_save = st_tmp;
    }
    t = t + rc[LAST] * st[LAST];  // the last tap reads the old state
    st[LAST] = st_save;
    if (i >= write_from) yu[n] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
tns_analysis_kernel(const float* __restrict__ x, const int* __restrict__ bounds,
                    const int* __restrict__ rc_order, const int* __restrict__ num_filters,
                    const float* __restrict__ rc_q, float* __restrict__ y, int S, int ne,
                    int row) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kStreams][row] the input rows
  float* ys = xs + kStreams * row;  // [kStreams][row] the output rows
  const int s0 = blockIdx.x * kStreams;
  const int nvalid = min(kStreams, S - s0);
  const int tid = threadIdx.x;

  lc3t::stage_rows<kThreads>(xs, row, x + (size_t)s0 * ne, ne, nvalid);

  // the warp's stream's filters and coefficients, loaded while the rows arrive
  const int u = tid >> 5, lane = tid & 31;
  const int s = s0 + min(u, nvalid - 1);
  const int ord0 = rc_order[2 * s], ord1 = num_filters[s] > 1 ? rc_order[2 * s + 1] : 0;
  const Segments g = segments(bounds[4 * s], bounds[4 * s + 1], bounds[4 * s + 2],
                              bounds[4 * s + 3], ord0, ord1, ne);
  float rcv[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) rcv[k] = rc_q[16 * (size_t)s + k];
  lc3t::wait_async_copies();
  __syncthreads();
  for (int i = tid; i < nvalid * row; i += kThreads) ys[i] = xs[i];  // lines outside the filters
  __syncthreads();

  if (u < nvalid) {
    int len[3], total = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) total += len[j] = g.end[j] - g.start[j];
    // lanes C lines apart, C odd: they hit distinct banks. Where filter 0
    // resumes after filter 1 (bounds LC3's tables never give), the taps
    // filter 1 holds carry filter 0's state across it, further back than the
    // warm-up reaches: lane 0 walks such a stream alone, from its first line.
    const int C = len[0] > 0 && len[2] > 0 ? total : ((total + 31) >> 5) | 1;
    const int r0 = min(lane * C, total), r1 = min(r0 + C, total);
    if (r0 < r1) {
      const float* xu = xs + u * row;
      float* yu = ys + u * row;
      float st[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) st[k] = 0.0f;
      // the warm-up and the chunk, numbers [r0 - kWarm, r1), one piece of a
      // segment at a time
      const int r = max(r0 - kWarm, 0);
      int rank = 0;  // active lines before segment j
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int a = max(r, rank), b = min(r1, rank + len[j]);
        if (a < b) {
          float rc[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) rc[k] = rcv[(j == 1 ? 8 : 0) + k];
          const int n = g.start[j] + a - rank, from = max(r0 - a, 0);
          switch (min(j == 1 ? ord1 : ord0, 8) - 1) {
            case 0: run<0>(xu, yu, n, b - a, from, rc, st); break;
            case 1: run<1>(xu, yu, n, b - a, from, rc, st); break;
            case 2: run<2>(xu, yu, n, b - a, from, rc, st); break;
            case 3: run<3>(xu, yu, n, b - a, from, rc, st); break;
            case 4: run<4>(xu, yu, n, b - a, from, rc, st); break;
            case 5: run<5>(xu, yu, n, b - a, from, rc, st); break;
            case 6: run<6>(xu, yu, n, b - a, from, rc, st); break;
            default: run<7>(xu, yu, n, b - a, from, rc, st); break;
          }
        }
        rank += len[j];
      }
    }
  }
  __syncthreads();

  lc3t::store_rows<kThreads>(y + (size_t)s0 * ne, ys, row, ne, nvalid);
}

}  // namespace

// x, y: [S, ne] f32, C-contiguous; bounds: [S, 2, 2] i32 (lo, hi per
// filter); rc_order: [S, 2] i32; num_filters: [S] i32 (the second filter
// runs only where it is > 1); rc_q: [S, 16] f32.
extern "C" int lc3t_tns_analysis(const float* x, const int* bounds, const int* rc_order,
                                 const int* num_filters, const float* rc_q, float* y, int S,
                                 int ne, void* stream) {
  const int row = (ne + 3) & ~3;  // a multiple of 4: 16-byte staging
  const size_t smem = sizeof(float) * 2 * kStreams * row;  // 12.8 KB at ne = 400
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (S + kStreams - 1) / kStreams;
  tns_analysis_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, bounds, rc_order, num_filters, rc_q, y, S, ne, row);
  return static_cast<int>(cudaGetLastError());
}
