// SNS analysis (encoder) around the PVQ search (sns_pvq.cu), as two kernels.
//
// sns_front: from the band energies e_b [S, nb] and the attack flags, the
// 16 scale factors (padding to 64 bands, three-tap smoothing,
// pre-emphasis, noise floor, log2, the 64 -> 16 grouping, mean removal,
// the attack smoothing), the stage-1 codebook search (the first minimum of
// 32 + 32 squared errors) and the DCT-16 rotation of the residual: t2rot
// [S, 16], st1 [S, 16], ind_lf and ind_hf [S] (int64, as argmin gives
// them). The PVQ search runs on t2rot between the two.
// sns_finish: from the PVQ search's outputs, st1 and the spectrum x, the
// two MPVQ enumerations and the joint index, the DCT-16 synthesis, the
// 64-point interpolation (with the 8 kHz / 7.5 ms narrow-band quirk),
// glibc's exp2f and the per-line shaping: x_shaped [S, ne] and the seven
// bitstream fields, int32 [7, S] (ind_lf, ind_hf, shape_j, gind, ls_inda,
// ls_indb, index_joint_j).
//
// Replaces no `pallas_call`: lc3jax/dsp/encoder.py:sns_analysis computes
// the stage as XLA glue, which XLA fused into the jitted step on the TPU.
// Eager PyTorch ran it as about 1,050 graph nodes a step (the two
// enumerations' 16 positions most of them). Semantics:
// dsp/encoder.py:sns_front_plain and sns_finish_plain, op for op; the
// oracle is lc3jax/ref/sns_enc.py.
//
// What bounds it on the H100: a stream reads nb energies, the PVQ outputs
// and ne lines and writes ne lines, about 3.4 KB at 48 kHz / 10 ms, 7 MB at
// S = 2048: 2 µs at 3.35 TB/s. What is left is each stream's chain: the
// 64-band total (63 dependent adds), the two 16-wide means, the codebook
// folds, and the enumerations (up to 16 dependent steps, a table lookup
// each).
//
// Design: the PVQ kernel's block layout, 16 streams a block (S = 2048 is
// 128 blocks) and 16 lanes a stream. A stream's lanes are one half-warp,
// so they exchange values through shared memory behind __syncwarp, with no
// block barrier. Lane k owns scale factor k: its four bands' smoothing and
// log2, group k's fold, the attack window around k, codebook rows k and
// k + 16 of each half, DCT output k's 16-term fold, synthesis row k, and
// interpolated points 4k..4k+3 with their exp2f. Each fold whose order the
// oracle pins (the 64-band total, the 16-wide means) is run whole by every
// lane from shared memory, in the plain version's order; that costs no
// more time than one lane and needs no broadcast. The codebook argmin is a
// butterfly over the 16 lanes in torch's argmin order (a NaN first, then
// the smaller value, then the lower index), which picks the first minimum
// whatever the tree's shape. Lane 0 enumerates shape A's pulses and lane 1
// set B's, side by side on one code path; lane 0 writes the fields. The
// shaped spectrum is written with the 16 lanes striding a stream's lines.
//
// Exactness: compiled with --fmad=false, so every product and sum rounds
// on its own, like the eager ops of the plain versions; each expression
// keeps their association. Divisions by the attack divisors are __fdiv_rn,
// as PyTorch divides a tensor by a divisor's tensor (a division by a power
// of two is exact either way). log2 is float64's, rounded once to f32, as
// fp.log2f; exp2f is glibc's algorithm in float64 on the table, shift and
// polynomial of data/exp2f.npz (dsp/libmexact.py), as the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 16;             // streams a block
constexpr int kThreads = 16 * kS;  // 16 lanes a stream
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON, encoder.EPS
constexpr int64_t kSzA = 2390004;                 // encoder.SZ_A
constexpr int64_t kJoint3 = 15158272;             // shape 3's index base

// torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// Whether (ov, oi) comes before (v, i) in torch's argmin order: a NaN
// first (the lower index among NaNs), then the smaller value, then the
// lower index.
__device__ __forceinline__ bool before(float ov, int oi, float v, int i) {
  const bool onan = ov != ov, nan = v != v;
  if (onan != nan) return onan;
  if (onan) return oi < i;
  return ov < v || (ov == v && oi < i);
}

__device__ __forceinline__ void argmin_step(float& v, int& i, int off) {
  const float ov = __shfl_xor_sync(kFull, v, off, 16);
  const int oi = __shfl_xor_sync(kFull, i, off, 16);
  if (before(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// The first minimum over the stream's 16 lanes of rows k and k + 16's
// squared errors (rows a lane holds: h = 0, 1), every lane gets it.
__device__ __forceinline__ int codebook_argmin(const float (&err)[2], int k) {
  float v = err[0];
  int i = k;
  if (before(err[1], k + 16, v, i)) {
    v = err[1];
    i = k + 16;
  }
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) argmin_step(v, i, off);
  return i;
}

// The squared error of eight scale factors against a codebook row, folded
// in the oracle's order.
__device__ __forceinline__ float row_error(const float* scf, const float (&row)[8]) {
  float acc = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float e = scf[n] - row[n];
    acc = n == 0 ? e * e : acc + e * e;
  }
  return acc;
}

// glibc exp2f (sysdeps/ieee754/flt-32/e_exp2f.c) in float64, as
// dsp/libmexact.py:exp2f computes it op for op.
__device__ __forceinline__ float exp2f_glibc(float xf, const uint64_t* __restrict__ tab,
                                             double shift, double p0, double p1, double p2) {
  const double xd = static_cast<double>(xf);
  double kd = xd + shift;
  const uint64_t ki = static_cast<uint64_t>(__double_as_longlong(kd));
  kd = kd - shift;
  const double r = xd - kd;
  const uint64_t t = tab[ki & 31] + (ki << 47);
  const double s = __longlong_as_double(static_cast<long long>(t));
  const double z = p0 * r + p1;
  const double r2 = r * r;
  double y = p2 * r + 1.0;
  y = z * r2 + y;
  y = y * s;
  return static_cast<float>(y);
}

__global__ void __launch_bounds__(kThreads) sns_front_kernel(
    const float* __restrict__ e_b, const bool* __restrict__ attack,
    const float* __restrict__ preemph, const int64_t* __restrict__ group_idx,
    const float* __restrict__ group_w, const float* __restrict__ div5,
    const float* __restrict__ div3, const float* __restrict__ lfcb,
    const float* __restrict__ hfcb, const float* __restrict__ dct16, float* __restrict__ t2rot,
    float* __restrict__ st1_out, int64_t* __restrict__ ind_lf_out,
    int64_t* __restrict__ ind_hf_out, int S, int nb, float atten) {
  __shared__ float s_e[kS][65];      // the band energies, then the bands' log2 values
  __shared__ float s_sm[kS][65];     // the smoothed, pre-emphasised bands
  __shared__ float s_f[kS][3][17];   // ds; ds after the mean; then att, scf, r1
  const int k = threadIdx.x & 15;
  const int u = threadIdx.x >> 4;
  const int sid = blockIdx.x * kS + u;
  const bool store = sid < S;
  const int s = store ? sid : S - 1;  // a stream past S repeats the last one, unstored

  // this lane's tables, loaded ahead of the chain
  float pre[4], gw[6], lf[2][8], hf[2][8], dcol[16];
  int gi[6];
#pragma unroll
  for (int j = 0; j < 4; ++j) pre[j] = preemph[4 * k + j];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    gi[j] = static_cast<int>(group_idx[6 * k + j]);
    gw[j] = group_w[6 * k + j];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      lf[h][n] = lfcb[(k + 16 * h) * 8 + n];
      hf[h][n] = hfcb[(k + 16 * h) * 8 + n];
    }
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) dcol[n] = dct16[n * 16 + k];
  const float d5 = *div5, d3 = *div3;
  const bool att_on = attack[s];

  const float* row = e_b + (size_t)s * nb;
  for (int j = k; j < nb; j += 16) s_e[u][j] = row[j];
  __syncwarp();

  // padding to 64 bands (the first 64 - nb bands twice), smoothing, pre-emphasis
  const int twice = 2 * (64 - nb);
  float* e = s_e[u];
  auto pad = [&](int i) { return e[i < twice ? i >> 1 : i - (64 - nb)]; };
  float sm[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * k + j;
    float v;
    if (i == 0) {
      v = 0.75f * pad(0) + 0.25f * pad(1);
    } else if (i == 63) {
      v = 0.25f * pad(62) + 0.75f * pad(63);
    } else {
      v = (0.25f * pad(i - 1) + 0.5f * pad(i)) + 0.25f * pad(i + 1);
    }
    sm[j] = v * pre[j];
    s_sm[u][i] = sm[j];
  }
  __syncwarp();

  // the 64-band total, the noise floor, log2
  float total = s_sm[u][0];
  for (int i = 1; i < 64; ++i) total = total + s_sm[u][i];
  float floor_v = (total / 64.0f) * 1e-4f;
  floor_v = floor_v < 0x1p-32f ? 0x1p-32f : floor_v;  // clamp_min: NaN stays
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = kEps + max_nan(sm[j], floor_v);
    e[4 * k + j] = static_cast<float>(log2(static_cast<double>(v))) / 2.0f;
  }
  __syncwarp();

  // group k's fold, the mean over the 16 groups
  float ds = e[gi[0]] * gw[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) ds = ds + e[gi[j]] * gw[j];
  s_f[u][0][k] = ds;
  __syncwarp();
  float mean = s_f[u][0][0];
  for (int n = 1; n < 16; ++n) mean = mean + s_f[u][0][n];
  ds = 0.85f * (ds - mean / 16.0f);
  s_f[u][1][k] = ds;
  __syncwarp();

  // the attack smoothing: windowed means in the oracle's fold order, then
  // the mean removed again and the attenuation
  const float* d = s_f[u][1];
  float att;
  if (k == 0) {
    att = __fdiv_rn((d[0] + d[1]) + d[2], d3);
  } else if (k == 1) {
    att = (((d[0] + d[1]) + d[2]) + d[3]) / 4.0f;
  } else if (k == 14) {
    att = (((d[12] + d[13]) + d[14]) + d[15]) / 4.0f;
  } else if (k == 15) {
    att = __fdiv_rn((d[13] + d[14]) + d[15], d3);
  } else {
    att = __fdiv_rn((((d[k - 2] + d[k - 1]) + d[k]) + d[k + 1]) + d[k + 2], d5);
  }
  s_f[u][0][k] = att;
  __syncwarp();
  float att_mean = s_f[u][0][0];
  for (int n = 1; n < 16; ++n) att_mean = att_mean + s_f[u][0][n];
  att = atten * (att - att_mean / 16.0f);
  const float scf = att_on ? att : ds;
  s_f[u][2][k] = scf;
  __syncwarp();

  // stage 1: the codebook rows' squared errors and their first minima
  const float* x = s_f[u][2];
  const float lf_err[2] = {row_error(x, lf[0]), row_error(x, lf[1])};
  const float hf_err[2] = {row_error(x + 8, hf[0]), row_error(x + 8, hf[1])};
  const int ind_lf = codebook_argmin(lf_err, k);
  const int ind_hf = codebook_argmin(hf_err, k);
  const float st1 = k < 8 ? lfcb[ind_lf * 8 + k] : hfcb[ind_hf * 8 + k - 8];
  s_f[u][0][k] = scf - st1;  // r1
  __syncwarp();

  // stage 2's rotation: output k folds r1[n] * D[n][k] over n
  const float* r1 = s_f[u][0];
  float t = r1[0] * dcol[0];
#pragma unroll
  for (int n = 1; n < 16; ++n) t = t + r1[n] * dcol[n];
  if (store) {
    t2rot[(size_t)s * 16 + k] = t;
    st1_out[(size_t)s * 16 + k] = st1;
    if (k == 0) {
      ind_lf_out[s] = ind_lf;
      ind_hf_out[s] = ind_hf;
    }
  }
}

__global__ void __launch_bounds__(kThreads) sns_finish_kernel(
    const float* __restrict__ x, int ldx, const float* __restrict__ st1_in,
    const int64_t* __restrict__ ind_lf, const int64_t* __restrict__ ind_hf,
    const int* __restrict__ y_sel, const int* __restrict__ y0s, const float* __restrict__ xq_sel,
    const int* __restrict__ shape_j, const int* __restrict__ gind,
    const float* __restrict__ g_sel, const float* __restrict__ dct16,
    const int64_t* __restrict__ mpvq_offsets, const int64_t* __restrict__ band_of_line,
    const uint64_t* __restrict__ exp2_tab, float* __restrict__ x_shaped,
    int* __restrict__ fields, int S, int ne, int nb, double shift, double p0, double p1,
    double p2) {
  __shared__ int64_t s_off[16 * 11];  // MPVQ_OFFSETS
  __shared__ float s_q[kS][17];       // xq_sel, then the quantised scale factors
  __shared__ float s_i[kS][65];       // the 64 interpolated points
  __shared__ float s_g[kS][65];       // the bands' gains
  for (int j = threadIdx.x; j < 16 * 11; j += kThreads) s_off[j] = mpvq_offsets[j];
  __syncthreads();
  const int k = threadIdx.x & 15;
  const int u = threadIdx.x >> 4;
  const int sid = blockIdx.x * kS + u;
  const bool store = sid < S;
  const int s = store ? sid : S - 1;  // a stream past S repeats the last one, unstored

  float drow[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) drow[c] = dct16[k * 16 + c];
  const int sj = shape_j[s];
  const int g_ind = gind[s];
  const float g = g_sel[s];
  const float st1 = st1_in[(size_t)s * 16 + k];
  s_q[u][k] = xq_sel[(size_t)s * 16 + k];

  // the enumeration's pulses: lane 1 set B's (y0s[10..15] over 6
  // positions), every other lane shape A's (y_sel over 16 positions for
  // shapes 2 and 3, 10 for shapes 0 and 1); lanes 0 and 1 are read
  const bool set_b = k == 1;
  const int dims = set_b ? 6 : (sj >= 2 ? 16 : 10);
  const int* yrow = set_b ? y0s + (size_t)s * 16 + 10 : y_sel + (size_t)s * 16;
  int yv[16];
#pragma unroll
  for (int pos = 0; pos < 16; ++pos) yv[pos] = pos < dims ? yrow[pos] : 0;
  __syncwarp();

  // synthesis: factor[k] folds xq[c] * D[k][c] over c
  float factor = s_q[u][0] * drow[0];
#pragma unroll
  for (int c = 1; c < 16; ++c) factor = factor + s_q[u][c] * drow[c];
  const float scfq = st1 + g * factor;
  __syncwarp();
  s_q[u][k] = scfq;
  __syncwarp();

  // points 4k..4k+3 of the interpolation: scfq[0] twice, four points
  // between each pair, two past the last
  const float* q = s_q[u];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = 4 * k + j;
    float v;
    if (p < 2) {
      v = q[0];
    } else if (p < 62) {
      const int i = (p - 2) >> 2, w = (p - 2) & 3;
      const float wv = w == 0 ? 0.125f : w == 1 ? 0.375f : w == 2 ? 0.625f : 0.875f;
      v = q[i] + wv * (q[i + 1] - q[i]);
    } else {
      v = q[15] + (p == 62 ? 0.125f : 0.375f) * (q[15] - q[14]);
    }
    s_i[u][p] = v;
  }
  __syncwarp();

  // band b's gain; below 64 bands the first 64 - nb take the mean of two
  // points and the rest all take point 64 - nb + 1 (the reference
  // encoder's narrow-band quirk)
  const int n2 = 64 - nb;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = 4 * k + j;
    if (b < nb) {
      const float* ip = s_i[u];
      const float v = n2 == 0 ? ip[b] : b < n2 ? (ip[2 * b] + ip[2 * b + 1]) / 2.0f : ip[n2 + 1];
      s_g[u][b] = exp2f_glibc(-v, exp2_tab, shift, p0, p1, p2);
    }
  }

  // the MPVQ enumeration, positions dims-1..0 (the oracle's row counter)
  int64_t index = 0, tmp_h = 0;
  int next_sign = -1, k_acc = 0;
#pragma unroll
  for (int pos = 15; pos >= 0; --pos) {
    if (pos < dims) {
      const int val = yv[pos];
      if (next_sign >= 0 && val != 0) index = 2 * index + next_sign;
      next_sign = val < 0 ? 1 : val > 0 ? 0 : next_sign;
      index = index + tmp_h;
      k_acc += val < 0 ? -val : val;
      const int nrow = pos == 0 ? dims - 1 : dims - pos;
      tmp_h = s_off[min(max(nrow, 0), 15) * 11 + min(k_acc, 10)];
    }
  }
  const int64_t ls = next_sign > 0 ? next_sign : 0;
  const int64_t idx_b = __shfl_sync(kFull, static_cast<long long>(index), 1, 16);
  const int64_t ls_b = __shfl_sync(kFull, static_cast<long long>(ls), 1, 16);
  __syncwarp();

  if (store) {
    if (k == 0) {
      const int64_t lsb_gain = g_ind & 1;
      int64_t joint;
      if (sj == 0) {
        joint = (2 * idx_b + ls_b + 2) * kSzA + index;
      } else if (sj == 1) {
        joint = lsb_gain * kSzA + index;
      } else if (sj == 2) {
        joint = index;
      } else {
        joint = kJoint3 + lsb_gain + 2 * index;
      }
      fields[0 * S + s] = static_cast<int>(ind_lf[s]);
      fields[1 * S + s] = static_cast<int>(ind_hf[s]);
      fields[2 * S + s] = sj;
      fields[3 * S + s] = g_ind;
      fields[4 * S + s] = static_cast<int>(ls);
      fields[5 * S + s] = sj == 0 ? static_cast<int>(ls_b) : 0;
      fields[6 * S + s] = static_cast<int>(joint);
    }
    const float* xr = x + (size_t)s * ldx;
    float* out = x_shaped + (size_t)s * ne;
    for (int l = k; l < ne; l += 16) out[l] = xr[l] * s_g[u][band_of_line[l]];
  }
}

}  // namespace

extern "C" int lc3t_sns_front(const float* e_b, const bool* attack, const float* preemph,
                              const int64_t* group_idx, const float* group_w, const float* div5,
                              const float* div3, const float* lfcb, const float* hfcb,
                              const float* dct16, float* t2rot, float* st1, int64_t* ind_lf,
                              int64_t* ind_hf, int S, int nb, float atten, void* stream) {
  if (S < 1 || nb < 32 || nb > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (S + kS - 1) / kS;
  sns_front_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e_b, attack, preemph, group_idx, group_w, div5, div3, lfcb, hfcb, dct16, t2rot, st1, ind_lf,
      ind_hf, S, nb, atten);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lc3t_sns_finish(const float* x, const float* st1, const int64_t* ind_lf,
                               const int64_t* ind_hf, const int* y_sel, const int* y0s,
                               const float* xq_sel, const int* shape_j, const int* gind,
                               const float* g_sel, const float* dct16,
                               const int64_t* mpvq_offsets, const int64_t* band_of_line,
                               const uint64_t* exp2_tab, float* x_shaped, int* fields, int S,
                               int ne, int ldx, int nb, double shift, double p0, double p1,
                               double p2, void* stream) {
  if (S < 1 || ne < 1 || ldx < ne || nb < 32 || nb > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (S + kS - 1) / kS;
  sns_finish_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ldx, st1, ind_lf, ind_hf, y_sel, y0s, xq_sel, shape_j, gind, g_sel, dct16, mpvq_offsets,
      band_of_line, exp2_tab, x_shaped, fields, S, ne, nb, shift, p0, p1, p2);
  return static_cast<int>(cudaGetLastError());
}
