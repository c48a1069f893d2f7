// The spectral bit model's table part (encoder): per spectral tuple, the
// arithmetic coder's cost of the escape ladder and of the final symbol, in
// 1/2048 bits; and, with emit_pack, the range coder's operands for the same
// tuple.
//
// Replaces the Pallas kernel lc3jax/dsp/pallas_bitmodel.py:_kernel (entry
// bitmodel_table_part, with and without emit_pack); semantics of
// lc3jax/dsp/encoder.py:bit_consumption (:1189-1261). Like the TPU kernel's
// _bitmodel_tables, the tables come precomposed for the launch's rate flag
// (dsp/bitmodel_kernel.py:compose_tables, exact integers), int32 words at:
//   0     [2, 4, 256]  (hi, L, c): pki | AC_SPEC_BITS[pki, 16] << 6, where
//                      pki = AC_SPEC_LOOKUP[c + rate_flag + 256 hi + 1024 L]
//   2048  [64, 17]     (pki, sym): AC_SPEC_BITS[pki, sym]
//   3136  [2, 4, 256]  (hi, L, c): CUMFREQ[pki, 16] + 1024 FREQ[pki, 16]
//   5184  [64, 17]     (pki, sym): CUMFREQ[pki, sym] + 1024 FREQ[pki, sym]
// (the last two are read only with emit_pack).
//
// emit_pack writes int32 [5 * NT, S], stream-minor, the layout the pack
// kernel reads: row L * NT + n (L = 0..3) holds the escape symbol's operand
// at ladder level L, row 4 * NT + n the final symbol's at level min(g, 3).
//
// What bounds it on the H100: 12 B in and 4 B out per coded tuple, 20 B
// more out with emit_pack (6.5 and 14.7 MB at S = 2048, NT = 200), and a
// few lookups: bytes. Design: a block owns a tile of 32 streams x 32
// tuples (448 blocks at S = 2048, NT = 200; tiles of 64, 128 or 224 tuples,
// which stage less, were 4-118% slower on the card) and stages the tables it
// reads (12.5 KB, 25 KB with emit_pack; only the hi halves its tuples
// touch). A warp's lanes are 32 neighbouring tuples of one stream: c, g, sym
// and out go 128 B a warp along the row. The operand rows go through a
// padded shared tile [5][32 tuples][33] and out along s, 32 streams (128 B)
// a store. Tuples at or past (lastnz + 1) >> 1 read nothing and write 0.
//
// Exact integer arithmetic: equal to the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kS = 32;         // streams a block
constexpr int kN = 32;         // tuples a block, a warp's lanes
constexpr int kEsc = 2048, kSym = 64 * 17;
constexpr int kEscWord = 0, kSymCost = kEsc, kEscOp = kEsc + kSym, kSymOp = 2 * kEsc + kSym;

// n int32 (a multiple of 4) from src to dst, both 16-byte aligned, 16 B a thread
__device__ __forceinline__ void stage(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads)
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
}

template <bool kEmit>
__global__ void __launch_bounds__(kThreads)
    bitmodel_kernel(const int* __restrict__ c, const int* __restrict__ g,
                    const int* __restrict__ sym, const int* __restrict__ lastnz,
                    const int* __restrict__ tab, int* __restrict__ out, int* __restrict__ pk,
                    int S, int NT, int ne4) {
  __shared__ __align__(16) int s_esc[kEsc];
  __shared__ __align__(16) int s_cost[kSym];
  __shared__ __align__(16) int s_eop[kEmit ? kEsc : 4];
  __shared__ __align__(16) int s_fop[kEmit ? kSym : 4];
  __shared__ int s_rows[kEmit ? 5 * kN * (kS + 1) : 1];  // [5][tuple][stream], padded
  __shared__ int s_lim[kS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * kS;
  const int n0 = blockIdx.y * kN;
  // the halves (n <= ne4: 0, n > ne4: 1) this block's tuples look up
  const int h0 = n0 > ne4 ? 1 : 0, nh = (min(n0 + kN, NT) - 1 > ne4 ? 1 : 0) - h0 + 1;
  stage(s_esc + 1024 * h0, tab + kEscWord + 1024 * h0, 1024 * nh);
  stage(s_cost, tab + kSymCost, kSym);
  if (kEmit) {
    stage(s_eop + 1024 * h0, tab + kEscOp + 1024 * h0, 1024 * nh);
    stage(s_fop, tab + kSymOp, kSym);
  }
  if (tid < kS) s_lim[tid] = s0 + tid < S ? (lastnz[s0 + tid] + 1) >> 1 : 0;
  __syncthreads();

  const int n = n0 + lane;
  const int hi = n > ne4 ? 1024 : 0;
  // warp w takes streams w, w + 8, w + 16, w + 24 of the block: loads first
  int cv[kS / 8], gv[kS / 8], sv[kS / 8];
  bool coded[kS / 8];
#pragma unroll
  for (int i = 0; i < kS / 8; ++i) {
    const int u = warp + 8 * i;
    coded[i] = s0 + u < S && n < NT && n < s_lim[u];
    cv[i] = gv[i] = sv[i] = 0;
    if (coded[i]) {
      const size_t at = (size_t)(s0 + u) * NT + n;
      cv[i] = c[at];
      gv[i] = g[at];
      sv[i] = sym[at];
    }
  }
#pragma unroll
  for (int i = 0; i < kS / 8; ++i) {
    const int u = warp + 8 * i;
    int est = 0, op[5] = {0, 0, 0, 0, 0};
    if (coded[i]) {
      const int* e = s_esc + hi + cv[i];
      const int w0 = e[0], w1 = e[256], w2 = e[512], w3 = e[768];
      const int G = gv[i];
      est = (G > 0 ? w0 >> 6 : 0) + (G > 1 ? w1 >> 6 : 0) + (G > 2 ? w2 >> 6 : 0) +
            (G > 3 ? (G - 3) * (w3 >> 6) : 0);
      const int wl = G == 0 ? w0 : G == 1 ? w1 : G == 2 ? w2 : w3;
      const int f = 17 * (wl & 63) + sv[i];
      est += s_cost[f];
      if (kEmit) {
        const int* eo = s_eop + hi + cv[i];
        op[0] = eo[0];
        op[1] = eo[256];
        op[2] = eo[512];
        op[3] = eo[768];
        op[4] = s_fop[f];
      }
    }
    if (s0 + u < S && n < NT) out[(size_t)(s0 + u) * NT + n] = est;
    if (kEmit) {
#pragma unroll
      for (int r = 0; r < 5; ++r) s_rows[(r * kN + lane) * (kS + 1) + u] = op[r];
    }
  }
  if (kEmit) {
    __syncthreads();
    // the block's 5 x 32 operand rows, 32 streams each, one row a warp at a time
    for (int k = warp; k < 5 * kN; k += kThreads / 32) {
      const int r = k / kN, n2 = n0 + (k - r * kN);
      if (n2 < NT && s0 + lane < S)
        pk[((size_t)r * NT + n2) * S + s0 + lane] = s_rows[k * (kS + 1) + lane];
    }
  }
}

}  // namespace

// c, g, sym, out: [S, NT] i32; lastnz: [S] i32; tab: the launch's rate
// flag's precomposed tables (6,272 int32, 16-byte aligned, on the device).
// pk: [5 * NT, S] i32, or null without emit_pack.
extern "C" int lc3t_bitmodel(const int* c, const int* g, const int* sym, const int* lastnz,
                             const int* tab, int* out, int* pk, int S, int NT, int ne4,
                             void* stream) {
  if (S <= 0 || NT <= 0) return 0;
  const dim3 grid((S + kS - 1) / kS, (NT + kN - 1) / kN);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pk != nullptr)
    bitmodel_kernel<true><<<grid, kThreads, 0, st>>>(c, g, sym, lastnz, tab, out, pk, S, NT, ne4);
  else
    bitmodel_kernel<false><<<grid, kThreads, 0, st>>>(c, g, sym, lastnz, tab, out, pk, S, NT, ne4);
  return static_cast<int>(cudaGetLastError());
}
