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
// What bounds it on the H100: 64 B in and 140 B out per stream, so neither
// bytes nor flops; the serial chain of the greedy rounds does (up to 18
// rounds of 15 dependent compare-and-select steps). Design: a block of 16
// streams (S = 2048 is 128 blocks, about one an SM) has a greedy warp, a
// lane a stream, and 16 search lanes a stream. The greedy scan is not
// associative under rounding, so a greedy lane loads its stream's row
// (staging it in shared memory for the search lanes) and runs the rounds in
// the plain version's order, only those the stream needs, and set B's
// argmax; running the rounds on all 16 lanes in lockstep issued 16 times
// the instructions and was slower on the card. The parts that are exactly
// parallel go across the search lanes: lane k normalises element k of each
// shape (one division each), folds candidate k's squared error alone in the
// oracle's order, and a first-minimum tree over the lanes picks the
// candidate, ties to the lower index j * 8 + g. Shapes 3 and 2 are final
// before shape 1's rounds start, so their 10 candidates are folded while
// the greedy warp runs those rounds (named barrier 1). Lane k then stores
// element k of each row.
//
// Exactness: compiled with --fmad=false, so every product rounds before the
// add that consumes it, like the eager PyTorch ops of sns_pvq_plain. The
// tree takes the higher-indexed range only when it is strictly smaller, so
// on finite errors it picks what the plain version's scan picks.
#include <cuda_runtime.h>

namespace {

constexpr int kS = 16;                 // streams a block
constexpr int kLanes = 16 * kS;        // the search lanes, 16 a stream
constexpr int kThreads = kLanes + 32;  // and the greedy warp, a lane a stream
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCands = 14;  // (j, g): (0, 0), (1, 0..2), (2, 0..2), (3, 0..6)

struct Acc {
  float corr_l, energy_l, corr_art, energy_art;
};

// One greedy round (a pulse is needed) over the first NACT lanes; ty[n] holds
// 2 y[n] (exact). A pulse's new accumulators are its candidate's own values:
// corr_l + |x| and (energy_l + 2 y) + 1, the same operations on the same
// operands as the plain version's update. (Deciding two lanes a step, with
// the second lane compared against both bests it can meet, was slower on
// the card: the compiler lengthened the chain it was meant to shorten.)
template <int NACT>
__device__ __forceinline__ void greedy(float (&ty)[16], const float (&ax)[16], Acc& a) {
  float cc[NACT], ce[NACT];
#pragma unroll
  for (int n = 0; n < NACT; ++n) {
    cc[n] = a.corr_l + ax[n];
    ce[n] = (a.energy_l + ty[n]) + 1.0f;
  }
  int nb = 0;
  float bsq = cc[0] * cc[0], ben = ce[0], bcc = cc[0];
#pragma unroll
  for (int l = 1; l < NACT; ++l) {
    const float sq = cc[l] * cc[l];
    const bool take = sq * ben > bsq * ce[l];
    nb = take ? l : nb;
    bsq = take ? sq : bsq;
    ben = take ? ce[l] : ben;
    bcc = take ? cc[l] : bcc;
  }
  a.corr_l = bcc;
  a.energy_l = ben;
  a.corr_art = cc[NACT - 1];
  a.energy_art = ce[NACT - 1];
#pragma unroll
  for (int n = 0; n < NACT; ++n) ty[n] = n == nb ? ty[n] + 2.0f : ty[n];
}

// a / b rounded to nearest, as `/` is (--prec-div); in PTX so that the
// compiler keeps the dividend given: a zero dividend fails the fast path's
// range check and takes the slow one, so the caller divides a stand-in.
__device__ __forceinline__ float div_rn(float a, float b) {
  float q;
  asm("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(a), "f"(b));
  return q;
}

// Candidate c's shape j and gain index gi in the order j * 8 + gi.
__device__ __forceinline__ int cand_shape(int c) { return c == 0 ? 0 : c < 4 ? 1 : c < 7 ? 2 : 3; }
__device__ __forceinline__ int cand_gain(int c) {
  return c == 0 ? 0 : c < 4 ? c - 1 : c < 7 ? c - 4 : c - 7;
}

// One step of the first-minimum tree over a stream's 16 lanes: this lane's
// range and the one `off` lanes away; the higher range wins only if its
// value is strictly smaller.
__device__ __forceinline__ void min_step(float& v, int& i, int k, int off) {
  const float ov = __shfl_xor_sync(kFull, v, off, 16);
  const int oi = __shfl_xor_sync(kFull, i, off, 16);
  const bool upper = (k & off) != 0;
  const float lo_v = upper ? ov : v, hi_v = upper ? v : ov;
  const int lo_i = upper ? oi : i, hi_i = upper ? i : oi;
  const bool take_hi = hi_v < lo_v;
  v = take_hi ? hi_v : lo_v;
  i = take_hi ? hi_i : lo_i;
}

// Named barrier 1: the greedy warp arrives once shapes 3 and 2 are in shared
// memory; the lanes wait for it, and fold those shapes' candidates while the
// greedy warp runs shape 1.
__device__ __forceinline__ void shapes_32_arrive() {
  asm volatile("barrier.arrive 1, %0;" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void shapes_32_wait() {
  asm volatile("barrier.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// Lane k's candidate's squared error against the normalised shape xq, folded
// in the oracle's order.
__device__ __forceinline__ float fold_mse(const float* x, const float* xq, float gv) {
  float mse = 0.0f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float d = x[n] - gv * xq[n];
    mse = n == 0 ? d * d : mse + d * d;
  }
  return mse;
}

__global__ void __launch_bounds__(kThreads)
    sns_pvq_kernel(const float* __restrict__ t2rot, int* __restrict__ y_sel,
                   int* __restrict__ y0s, float* __restrict__ xq_sel,
                   int* __restrict__ shape_j_out, int* __restrict__ gind_out,
                   float* __restrict__ g_sel_out, const float* __restrict__ gains, int S) {
  __shared__ float s_x[kS][17];
  __shared__ int s_y[3][kS][17];   // the pulses of shapes 1, 2, 3, without signs
  __shared__ int s_sq[3][kS];      // their sums of squares
  __shared__ int s_nb[kS];         // set B's pulse
  __shared__ float s_xq[kS][4][17];  // the normalised shapes 0..3, with signs
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kS;
  const int nvalid = min(kS, S - s0);

  if (tid >= kLanes) {  // the greedy warp: lane u runs stream u's projection and rounds
    const int u = tid - kLanes;
    float ax[16], ty[16];
    Acc a{0.0f, 0.0f, 0.0f, 0.0f};
    int kb = 0;
    if (u < nvalid) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {  // its row, also staged for the lanes
        const float x = t2rot[16 * (s0 + u) + n];
        s_x[u][n] = x;
        ax[n] = fabsf(x);
      }
      float abs_sum = ax[0];
#pragma unroll
      for (int n = 1; n < 16; ++n) abs_sum = abs_sum + ax[n];
      const float proj = 5.0f / abs_sum;
      int k0 = 0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int v = (int)floorf(ax[n] * proj);
        ty[n] = 2.0f * (float)v;
        k0 += v;
      }
      float corr = 0.5f * ty[0] * ax[0], energy = (0.5f * ty[0]) * (0.5f * ty[0]);
#pragma unroll
      for (int n = 1; n < 16; ++n) {
        corr = corr + (0.5f * ty[n]) * ax[n];
        energy = energy + (0.5f * ty[n]) * (0.5f * ty[n]);
      }

      // shape 3: K = 6 pulses (a round where none is needed changes nothing)
      a = Acc{corr, energy, corr, energy};
      for (int r = 0, count = k0; r < 6 && count < 6; ++r, ++count) greedy<16>(ty, ax, a);
      int sq3 = 0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        s_y[2][u][n] = (int)ty[n] >> 1;
        sq3 += ((int)ty[n] >> 1) * ((int)ty[n] >> 1);
      }
      s_sq[2][u] = sq3;
      // shape 2: two more pulses from the artifact accumulators
      a.corr_l = a.corr_art;
      a.energy_l = a.energy_art;
      for (int r = 0; r < 2; ++r) greedy<16>(ty, ax, a);
      int sq2 = 0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        s_y[1][u][n] = (int)ty[n] >> 1;
        sq2 += ((int)ty[n] >> 1) * ((int)ty[n] >> 1);
        if (n >= 10) kb += (int)ty[n] >> 1;
      }
      s_sq[1][u] = sq2;
    }
    shapes_32_arrive();

    if (u < nvalid) {
      // shape 1: strip set B, re-add pulses in set A up to K = 10
      a.corr_l = a.corr_art;
      a.energy_l = a.energy_art;
#pragma unroll
      for (int n = 10; n < 16; ++n) {
        const float v = 0.5f * ty[n];
        if (v != 0.0f) {
          a.corr_l = a.corr_l - v * ax[n];
          a.energy_l = a.energy_l - v * v;
        }
        ty[n] = 0.0f;
      }
      for (int r = 0, count = 8 - kb; r < 10 && count < 10; ++r, ++count) greedy<10>(ty, ax, a);
      int sq1 = 0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        s_y[0][u][n] = (int)ty[n] >> 1;
        sq1 += ((int)ty[n] >> 1) * ((int)ty[n] >> 1);
      }
      s_sq[0][u] = sq1;

      // shape 0: y1 plus one pulse at the largest |x| of set B (first wins)
      int nb = 10;
      float b_best = ax[10];
#pragma unroll
      for (int n = 11; n < 16; ++n) {
        nb = ax[n] > b_best ? n : nb;
        b_best = ax[n] > b_best ? ax[n] : b_best;
      }
      s_nb[u] = nb;
    }
    __syncthreads();
    return;
  }

  // 16 lanes a stream: lane k of stream u (a stream past S reads the block's
  // last valid one and stores nothing). Lane k normalises element k of each
  // shape: the fold of a shape's squares adds integers of at most 101 in
  // all, exact in f32 in any order, so its integer sum is the plain
  // version's fold.
  const int k = tid & 15, u = tid >> 4;
  const int cand = min(k, kCands - 1);  // this lane's candidate in the search
  const int j = cand_shape(cand);
  const float gv = gains[8 * j + cand_gain(cand)];
  const bool valid = u < nvalid;
  const int row = valid ? u : nvalid - 1;
  float mse = 0.0f;

  // shapes 3 and 2, while the greedy warp runs shape 1
  shapes_32_wait();
  const int sg = s_x[row][k] < 0.0f ? -1 : 1;
  const int y3 = s_y[2][row][k], y2 = s_y[1][row][k];
  const float norm3 = sqrtf((float)s_sq[2][row]), norm2 = sqrtf((float)s_sq[1][row]);
  const float yf3 = (float)(sg * y3), yf2 = (float)(sg * y2);
  const float q3 = div_rn(yf3 != 0.0f ? yf3 : 1.0f, norm3);
  const float q2 = div_rn(yf2 != 0.0f ? yf2 : 1.0f, norm2);
  s_xq[u][3][k] = yf3 != 0.0f ? q3 : yf3;
  s_xq[u][2][k] = yf2 != 0.0f ? q2 : yf2;
  __syncwarp();
  if (j >= 2) mse = fold_mse(s_x[row], s_xq[u][j], gv);

  // shapes 1 and 0, once the rounds are done
  __syncthreads();
  const int nb = s_nb[row];
  const int y1 = s_y[0][row][k];
  const int y0 = k == nb ? 1 : y1;
  const float norm_k = sqrtf((float)(s_sq[0][row] + (k & 1 ? 0 : 1)));  // lanes 0 and 1
  const float norm0 = __shfl_sync(kFull, norm_k, 0, 16), norm1 = __shfl_sync(kFull, norm_k, 1, 16);
  const float yf1 = k >= 10 ? 0.0f : (float)(sg * y1), yf0 = (float)(sg * y0);
  const float q1 = div_rn(yf1 != 0.0f ? yf1 : 1.0f, norm1);
  const float q0 = div_rn(yf0 != 0.0f ? yf0 : 1.0f, norm0);
  s_xq[u][1][k] = yf1 != 0.0f ? q1 : yf1;
  s_xq[u][0][k] = yf0 != 0.0f ? q0 : yf0;
  __syncwarp();
  if (j < 2) mse = fold_mse(s_x[row], s_xq[u][j], gv);

  // the first minimum over the candidates, ties to the lower index
  if (k >= kCands) mse = __int_as_float(0x7f800000);  // +inf: never strictly better
  int best_c = k;
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) min_step(mse, best_c, k, off);
  const float g_sel = __shfl_sync(kFull, gv, best_c, 16);
  if (!valid) return;

  // lane k's element of each row
  const int shape_j = cand_shape(best_c), gind = cand_gain(best_c);
  const int s = s0 + u;
  const int ys = shape_j == 0 ? y0 : shape_j == 1 ? y1 : shape_j == 2 ? y2 : y3;
  y_sel[16 * s + k] = sg * ys;
  y0s[16 * s + k] = sg * y0;
  xq_sel[16 * s + k] = s_xq[u][shape_j][k];
  if (k == 0) {
    shape_j_out[s] = shape_j;
    gind_out[s] = gind;
    g_sel_out[s] = g_sel;
  }
}

}  // namespace

// t2rot, y_sel, y0s, xq_sel: [S, 16]; shape_j, gind, g_sel: [S]; gains: the
// searched gains per shape, [4, 8] zero-padded, on the device.
extern "C" int lc3t_sns_pvq(const float* t2rot, int* y_sel, int* y0s, float* xq_sel,
                            int* shape_j, int* gind, float* g_sel, const float* gains,
                            int S, void* stream) {
  if (S <= 0) return 0;
  sns_pvq_kernel<<<(S + kS - 1) / kS, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t2rot, y_sel, y0s, xq_sel, shape_j, gind, g_sel, gains, S);
  return static_cast<int>(cudaGetLastError());
}
