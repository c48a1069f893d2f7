// LC3 frame parser: raw frame bytes -> ParsedFrames fields, the whole frame
// in one launch, a warp a stream and 16 streams a block.
//
// Replaces the Pallas kernel lc3jax/coding/pallas_parse.py:_parse_kernel
// (entry device_parse_pallas) together with the XLA work around it (side
// info, MPVQ de-enumeration, the bad-frame masking of pallas_parse.py:
// 696-743). Semantics are those of lc3jax/coding/device.py:device_parse,
// field for field, bad frames included: a corrupt frame keeps decoding with
// its error flags set (reads past either end of the payload are clamped, as
// in the XLA formulation), and at the end x_int, nf_seed, ltpf_active and
// pitch_index are zeroed while the other side fields keep their values.
// The scalar structure follows the host parser (native/lc3_bitstream.cc:
// Reader, read_side_info, RangeDec, mpvq_deenum, parse_head, spec_loop1,
// parse_tail) without its host tricks: no reciprocal or quotient tables,
// no SIMD, no frame interleaving.
//
// What bounds it on the H100: each stream is a serial chain of range-decoder
// symbols (up to ne/2 tuples, each one or more dependent symbol decodes with
// byte pulls), so the kernel is bound by the chains, not by its bytes. On
// the previous design (commit 308f410: one thread a stream reading
// everything from device memory, 16 blocks at S = 2048) a spectral symbol
// took about 1,600 cycles and the residual pass a quarter of the kernel
// (tools/kernel_phases.py); with everything on chip but still a lane a
// stream, the lanes of a warp diverged at every escape, renormalisation and
// sign (PERF.md). So here:
//
// - a warp a stream, 16 streams a block (128 blocks of 512 threads at
//   S = 2048). The warp's lanes run the stream's range decoder in lockstep,
//   so no lane diverges from another, and a symbol's search over its row of
//   cumulative frequencies is one compare a lane, a ballot and two shuffles
//   (Frame::decode) instead of 16 compares in a row; the SM interleaves the
//   block's 16 chains;
// - the block copies its 16 payload rows and a table image into shared
//   memory with 16-byte loads: the spectral lookup as u8, the cumulative
//   frequency rows as u16 without their leading 0 (a symbol's frequency is
//   the next entry less its own, 1024 past the last), the MPVQ offsets as
//   int32 (parse_kernel.py:table_image);
// - x and the tuples' escape levels stay in shared memory; the warp's 32
//   lanes take the passes over lines: the residual bits (a ballot and popc
//   prefix count of the nonzero lines) and the noise-filling seed (a
//   shuffle reduction); the LSB refinement, which spends a budget in line
//   order, and the MPVQ de-enumeration stay on lane 0;
// - the block writes its rows out as linear 16-byte copies (a block's rows
//   are contiguous in every output) into two pooled buffers, int32 and
//   uint8, laid out as parse_kernel.py:output_views hands them out.
//
// Every output field of every stream is written on every path. Integer
// arithmetic throughout.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_copy.cuh"

namespace {

using lc3t::align16;
using lc3t::block_copy;

constexpr int kStreams = 16;              // streams a block, a warp each
constexpr int kThreads = 32 * kStreams;
constexpr unsigned kFull = 0xffffffffu;

// byte offsets into the table image (lc3jax_torch/coding/parse_kernel.py)
constexpr int kLookup = 0;         // u8 [4096]
constexpr int kSpecCum = 4096;     // u16 [64][16]: AC_SPEC_CUMFREQ[:, 1:]
constexpr int kCoefCum = 6144;     // u16 [8][16]: AC_TNS_COEF_CUMFREQ[:, 1:]
constexpr int kOrderCum = 6400;    // u16 [2][8]: AC_TNS_ORDER_CUMFREQ[:, 1:], then 0
constexpr int kMpvq = 6432;        // i32 [16][11]: MPVQ_OFFSETS
constexpr int kTableBytes = 7136;

// rows of [S] after x_int [S, ne], rc_order [S, 2], rc_i [S, 16] and
// sns_y [S, 16] in the int32 pool, and after residual_bits [S, ne] in the
// uint8 pool (parse_kernel.py:I32_ROWS, U8_ROWS)
enum I32Row { kGgInd, kBandwidth, kNoiseFactor, kNfSeed, kNResidual, kSnsShape, kSnsGind,
              kSnsIndLf, kSnsIndHf, kPitchIndex, kI32Rows };
enum U8Row { kLsbMode, kZeroFrame, kLtpfActive, kBadFrame, kU8Rows };

struct Frame {
  const uint8_t* buf;  // the stream's payload row, in shared memory
  int nbytes;
  int cursor = 0;   // tail bit cursor
  bool tail_err = false;
  int head = 0;     // head byte cursor
  bool err = false;
  uint32_t low = 0, rng = 0;

  // The byte at i, clamped to the payload; an empty payload (a lost
  // packet delivered as a zero-byte frame) reads as zeros, and its first
  // side-info read overruns, so the frame is concealed.
  __device__ int byte_at(int i) const {
    if (nbytes < 1) return 0;
    i = i < 0 ? 0 : (i > nbytes - 1 ? nbytes - 1 : i);
    return buf[i];
  }

  // Backwards read of nbits (<= 25) from a 32-bit window at the cursor;
  // advances by adv and flags an overrun as buffer_reader.rs:72 does.
  __device__ uint32_t read(int nbits, int adv, bool active) {
    const int byte_index = cursor >> 3;
    const int base = nbytes - 1 - byte_index;
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
      const int idx = base - j;
      const uint32_t v = idx >= 0 ? uint32_t(byte_at(idx)) : 0u;
      w |= v << (8 * j);
    }
    const int bit = cursor & 7;
    const uint32_t value = (w >> bit) & ((1u << nbits) - 1u);
    const int bits_left = 8 - bit;
    const int nb = (adv >> 3) + ((adv > bits_left && adv < 8) ? 2 : 1);
    if (active && adv > 0 && nbytes - byte_index - nb < 0) tail_err = true;
    cursor += adv;
    return value;
  }
  __device__ uint32_t read(int nbits) { return read(nbits, nbits, true); }
  __device__ uint32_t read_masked(int nbits, bool on) {
    const uint32_t v = read(nbits, on ? nbits : 0, on);
    return on ? v : 0u;
  }

  // One tail bit at cursor c (buffer_reader.rs:104 overrun rule).
  __device__ int tail_bit(int& c, bool on, bool& e) const {
    if (!on) return 0;
    const int byte_index = c >> 3;
    const int v = (byte_at(nbytes - 1 - byte_index) >> (c & 7)) & 1;
    if (nbytes - head - byte_index + 2 < 0) e = true;
    c += 1;
    return v;
  }

  __device__ int head_byte() {
    const int v = byte_at(head);
    if (head >= nbytes) err = true;
    head += 1;
    return v;
  }

  // Range-decode one symbol, the warp in lockstep, over a row of K
  // cumulative frequencies given as entries 1..K-1 (u16; entry 0 is 0, the
  // total 1024). Lane j holds entry j and lane K the total. The row is
  // monotone, so the lanes whose entry is <= low / (rng >> 10) are 1..sym:
  // one compare a lane, a ballot and a popc give the symbol, two shuffles
  // its cum and cum + freq.
  template <int K>
  __device__ int decode(const uint16_t* row) {
    const int lane = threadIdx.x & 31;
    const uint32_t tmp = rng >> 10;
    if (low >= (tmp << 10)) err = true;
    const uint32_t c = lane == 0 ? 0u : (lane < K ? uint32_t(row[lane - 1]) : 1024u);
    const int val = __popc(__ballot_sync(kFull, lane > 0 && lane < K && low >= tmp * c));
    const uint32_t lo = __shfl_sync(kFull, c, val), hi = __shfl_sync(kFull, c, val + 1);
    low -= tmp * lo;
    rng = tmp * (hi - lo);
    for (int it = 0; it < 2; ++it) {
      if (rng < 0x10000u) {
        const uint32_t b = uint32_t(head_byte());
        low = ((low << 8) & 0x00FFFFFFu) + b;
        rng <<= 8;
      }
    }
    return val;
  }
};

__device__ void mpvq_deenum(const int* offsets, int dim, int k_val, int ls_ind, int ind, int* y) {
  int lead = ls_ind == 0 ? 1 : -1;
  int k_max = k_val;
  for (int p = 0; p < dim; ++p) {
    const int* row = offsets + 11 * (dim - 1 - p);
    if (ind == 0) {
      y[p] = k_max * lead;
      return;
    }
    int cnt = 0;
    for (int j = 1; j < 11; ++j) cnt += ind >= row[j] ? 1 : 0;
    const int k_acc = k_max < cnt ? k_max : cnt;
    const int ind_new = ind - row[k_acc];
    const int k_delta = k_max - k_acc;
    if (k_delta != 0) {
      y[p] = k_delta * lead;
      lead = (ind_new & 1) ? -1 : 1;
      ind = ind_new >> 1;
      k_max = k_acc;
    } else {
      ind = ind_new;
    }
  }
}

__global__ void __launch_bounds__(kThreads) parse_kernel(
    const uint8_t* __restrict__ payloads, const uint8_t* __restrict__ tables,
    int* __restrict__ pool32, uint8_t* __restrict__ pool8, int S, int nbytes, int ne,
    int fs_ind, int is_7p5) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_rc_order[kStreams][2];
  __shared__ int s_rc_i[kStreams][16];
  __shared__ int s_sns_y[kStreams][16];
  __shared__ int s_rows32[kI32Rows][kStreams];
  __shared__ uint8_t s_rows8[kU8Rows][kStreams];

  const int NT = ne / 2;
  const uint8_t* tab = smem;
  uint8_t* pay = smem + kTableBytes;                                 // [kStreams][nbytes]
  int* xs = reinterpret_cast<int*>(pay + align16(kStreams * nbytes));  // [kStreams][ne]
  uint8_t* res = reinterpret_cast<uint8_t*>(xs + kStreams * ne);      // [kStreams][ne]
  uint8_t* levs = res + kStreams * ne;                                // [kStreams][ne / 2]

  const int s0 = blockIdx.x * kStreams;
  const int nvalid = min(kStreams, S - s0);
  const int tid = threadIdx.x, lane = tid & 31;
  const int u = tid >> 5;  // this warp's stream in the block

  // ---------------- stage: tables, payload rows; x starts at 0
  block_copy(smem, tables, kTableBytes);
  block_copy(pay, payloads + (size_t)s0 * nbytes, nvalid * nbytes);
  for (int i = tid; i < kStreams * ne / 4; i += kThreads)
    reinterpret_cast<int4*>(xs)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  if (u < nvalid) {
    int* x = xs + u * ne;
    uint8_t* lev_row = levs + u * NT;
    const int nbits = nbytes * 8;

    // the stream's fields: every lane decodes the stream in lockstep (the
    // symbol search is the one step that splits over the lanes), so each
    // holds them
    Frame f;
    f.buf = pay + u * nbytes;
    f.nbytes = nbytes;
    bool bad = false, lsb_mode = false, neg_budget = false, ltpf_active = false;
    int lastnz = 0, gg_ind = 0, p_bw = 0, g_ind = 0, shape_j = 0, ind_lf = 0, ind_hf = 0;
    int ls_inda = 0, ls_indb = 0, idx_a = 0, idx_b = 0, pitch_index = 0, noise_factor = 0;
    int nres_avail = 0;
    {
      // ---------------- side info (side_info_reader.rs:29-103)
      const int kNbitsBw[5] = {0, 1, 2, 2, 3};
      const int nbits_bw = kNbitsBw[fs_ind];
      if (nbits_bw > 0) {
        p_bw = int(f.read(nbits_bw));
        if (p_bw > fs_ind) { bad = true; p_bw = fs_ind; }
      }
      int lastnz_bits = 0;
      while ((1 << lastnz_bits) < ne / 2) ++lastnz_bits;
      lastnz = (int(f.read(lastnz_bits)) + 1) << 1;
      if (lastnz > ne) { bad = true; lastnz = ne; }
      lsb_mode = f.read(1) != 0;
      gg_ind = int(f.read(8));
      const int num_tns = p_bw < 3 ? 1 : 2;
      const int rc_flag0 = int(f.read(1));
      const int rc_flag1 = int(f.read_masked(1, num_tns == 2));
      const bool pitch_present = f.read(1) != 0;
      ind_lf = int(f.read(5));
      ind_hf = int(f.read(5));
      const int submode_msb = int(f.read(1));
      const uint32_t g2 = f.read(2, submode_msb == 0 ? 1 : 2, true);
      g_ind = submode_msb == 0 ? int(g2 & 1u) : int(g2 & 3u);
      ls_inda = int(f.read(1));
      const bool msb0 = submode_msb == 0;
      int tmp = int(f.read(25, msb0 ? 25 : 24, true));
      if (!msb0) tmp &= 0xFFFFFF;
      if (msb0 ? tmp >= 33460056 : tmp >= 16708096) bad = true;
      int submode_lsb;
      if (msb0) {
        const int idx_bor = tmp / 2390004;
        idx_a = tmp - idx_bor * 2390004;
        submode_lsb = idx_bor - 2 < 0 ? 1 : 0;
        const int ib = idx_bor - 2 + submode_lsb * 2;
        if (submode_lsb != 0) {
          g_ind = (g_ind << 1) + ib;
        } else {
          idx_b = ib >> 1;
          ls_indb = ib & 1;
        }
      } else {
        const bool hi = tmp >= 15158272;
        const int tmp2 = tmp - (hi ? 15158272 : 0);
        submode_lsb = hi ? 1 : 0;
        if (hi) g_ind = (g_ind << 1) + (tmp2 & 1);
        idx_a = hi ? (tmp2 >> 1) : tmp2;
      }
      shape_j = (submode_msb << 1) + submode_lsb;
      ltpf_active = f.read_masked(1, pitch_present) != 0;
      pitch_index = int(f.read_masked(9, pitch_present));
      noise_factor = int(f.read(3));
      bad = bad || f.tail_err;

      // ---------------- arithmetic decoder init (arithmetic_codec.rs:57-65)
      {
        const uint32_t b0 = f.head_byte(), b1 = f.head_byte(), b2 = f.head_byte();
        f.low = (b0 << 16) | (b1 << 8) | b2;
        f.rng = 0x00FFFFFFu;
      }

      // ---------------- TNS order and coefficients (arithmetic_codec.rs:307-344)
      const int lpcw = nbits < (is_7p5 ? 360 : 480) ? 1 : 0;
      int* rc_i = s_rc_i[u];
      for (int k = 0; k < 16; ++k) rc_i[k] = 0;
      const int rc_flag[2] = {rc_flag0, rc_flag1};
      for (int fi = 0; fi < 2; ++fi) {
        int order = rc_flag[fi];
        if (fi < num_tns && order > 0) {
          order = f.decode<8>(reinterpret_cast<const uint16_t*>(tab + kOrderCum) + 8 * lpcw) + 1;
          for (int k = 0; k < order; ++k)
            rc_i[fi * 8 + k] =
                f.decode<17>(reinterpret_cast<const uint16_t*>(tab + kCoefCum) + 16 * k);
        }
        s_rc_order[u][fi] = order;
      }

      // ---------------- spectral tuples (arithmetic_codec.rs:211-305)
      const uint16_t* spec = reinterpret_cast<const uint16_t*>(tab + kSpecCum);
      const int rate_flag = nbits > (160 + fs_ind * 160) ? 512 : 0;
      const int nlast = bad ? 0 : lastnz;  // x past lastnz (or all of it, if bad) stays 0
      int c = 0;
      for (int n = 0; n < nlast; n += 2) {
        const int tc = c + rate_flag + (n > ne / 2 ? 256 : 0);
        int xk = 0, xk1 = 0, sym = 0, lev = 0;
        for (int level = 0; level < 14; ++level) {
          int li = tc + (lev < 3 ? lev : 3) * 1024;
          li = li < 0 ? 0 : (li > 4095 ? 4095 : li);
          sym = f.decode<17>(spec + 16 * tab[kLookup + li]);
          if (sym < 16) break;
          if (!lsb_mode || lev > 0) {
            xk += f.tail_bit(f.cursor, true, f.err) << lev;
            xk1 += f.tail_bit(f.cursor, true, f.err) << lev;
          }
          ++lev;
        }
        lev_row[n >> 1] = uint8_t(lsb_mode ? lev : 0);
        const int a = sym & 3, b = sym >> 2;
        xk += a << lev;
        xk1 += b << lev;
        if (f.tail_bit(f.cursor, xk > 0, f.err)) xk = -xk;
        if (f.tail_bit(f.cursor, xk1 > 0, f.err)) xk1 = -xk1;
        const int lev_c = lev < 3 ? lev : 3;
        const int t_next = lev_c <= 1 ? 1 + (a + b) * (lev_c + 1) : 12 + lev_c;
        c = (c & 15) * 16 + t_next;
        x[n] = xk;
        x[n + 1] = xk1;
      }

      // ---------------- the residual budget (arithmetic_codec.rs:160-208, 390-405)
      int log2rng = 0;
      for (int k = 1; k <= 24; ++k) log2rng += f.rng >= (1u << k) ? 1 : 0;
      const int nbits_side = f.cursor - 8;
      const int nbits_ari = (f.head + 1 - 3) * 8 + 25 - log2rng;
      neg_budget = nbits < nbits_side + nbits_ari;
      nres_avail = nbits - nbits_side - nbits_ari;
      nres_avail = nres_avail > 0 ? nres_avail : 0;
    }
    __syncwarp();

    // ---------------- residual bits, the warp over the lines: the k-th
    // nonzero line takes tail bit k - 1 past the cursor while the budget
    // lasts (not in LSB mode)
    const int cursor = f.cursor, head = f.head, avail = nres_avail;
    const bool lsb = lsb_mode;
    uint8_t* rr = res + u * ne;
    int base = 0, n_res = 0;
    bool err = false;
    for (int k0 = 0; k0 < ne; k0 += 32) {
      const int k = k0 + lane;
      const bool nz = k < ne && x[k] != 0;
      const unsigned m = __ballot_sync(kFull, nz);
      const int bitpos = base + __popc(m & (kFull >> (31 - lane))) - 1;
      const bool can_read = nz && bitpos < avail && !lsb;
      int bit = 0;
      if (can_read) {
        const int rcur = cursor + bitpos;
        const int byte_index = rcur >> 3;
        const int idx = nbytes - 1 - byte_index;
        bit = (f.byte_at(idx) >> (rcur & 7)) & 1;
        if (nbytes - head - byte_index + 2 < 0) err = true;
      }
      if (k < ne) rr[k] = uint8_t(bit);
      n_res += __popc(__ballot_sync(kFull, can_read));
      base += __popc(m);
    }
    err = __any_sync(kFull, err);
    bad = bad || f.err || err || neg_budget;

    // lane 0 alone from here to the rows: the LSB refinement rewrites x in
    // place, which the lanes must not race on
    if (lane == 0) {
      // ---------------- LSB refinement (sequential, budgeted)
      if (lsb_mode && !bad) {
        int cur = f.cursor, budget = nres_avail;
        bool lerr = false;
        for (int n = 0; n < lastnz; n += 2) {
          if (lev_row[n >> 1] == 0) continue;
          for (int i = n; i < n + 2; ++i) {
            const bool can = budget > 0;
            const int b1 = f.tail_bit(cur, can, lerr);
            budget -= can ? 1 : 0;
            const int xv = x[i];
            if (can && b1) {
              if (xv > 0) {
                x[i] = xv + 1;
              } else if (xv < 0) {
                x[i] = xv - 1;
              } else if (budget > 0) {
                const int b2 = f.tail_bit(cur, true, lerr);
                budget -= 1;
                x[i] = b2 ? -1 : 1;
              }
            }
          }
        }
        bad = bad || lerr;
      }

      // ---------------- MPVQ de-enumeration (spectral_noise_shaping.rs:155-199)
      int* y = s_sns_y[u];
      for (int k = 0; k < 16; ++k) y[k] = 0;
      const int* mpvq = reinterpret_cast<const int*>(tab + kMpvq);
      if (shape_j <= 1) {
        mpvq_deenum(mpvq, 10, 10, ls_inda, idx_a, y);
        if (shape_j == 0) mpvq_deenum(mpvq, 6, 1, ls_indb, idx_b, y + 10);
      } else {
        mpvq_deenum(mpvq, 16, shape_j == 2 ? 8 : 6, ls_inda, idx_a, y);
      }

      s_rows32[kGgInd][u] = gg_ind;
      s_rows32[kBandwidth][u] = p_bw;
      s_rows32[kNoiseFactor][u] = noise_factor;
      s_rows32[kNResidual][u] = lsb_mode ? 0 : n_res;
      s_rows32[kSnsShape][u] = shape_j;
      s_rows32[kSnsGind][u] = g_ind;
      s_rows32[kSnsIndLf][u] = ind_lf;
      s_rows32[kSnsIndHf][u] = ind_hf;
      s_rows32[kPitchIndex][u] = bad ? 0 : pitch_index;
      s_rows8[kLsbMode][u] = lsb_mode;
      s_rows8[kZeroFrame][u] = lastnz == 2 && x[0] == 0 && x[1] == 0 && gg_ind == 0;
      s_rows8[kLtpfActive][u] = ltpf_active && !bad;
      s_rows8[kBadFrame][u] = bad;
    }
    __syncwarp();

    // ---------------- the noise-filling seed, the warp over the lines: the
    // sum of |x[k]| k; then a bad frame's x becomes 0
    bad = __shfl_sync(kFull, int(bad), 0) != 0;
    uint32_t acc = 0;
    for (int k = lane; k < ne; k += 32) {
      const int v = x[k];
      acc += uint32_t(v < 0 ? -v : v) * uint32_t(k);
      if (bad) x[k] = 0;
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) s_rows32[kNfSeed][u] = bad ? 0 : int(acc & 0xFFFFu);
  }
  __syncthreads();

  // ---------------- the block's rows out: linear copies of each output's
  // contiguous run of rows
  block_copy(reinterpret_cast<uint8_t*>(pool32 + (size_t)s0 * ne), reinterpret_cast<uint8_t*>(xs),
             nvalid * ne * 4);
  block_copy(pool8 + (size_t)s0 * ne, res, nvalid * ne);
  int* const rc_order_o = pool32 + (size_t)S * ne;
  int* const rc_i_o = rc_order_o + (size_t)S * 2;
  int* const sns_y_o = rc_i_o + (size_t)S * 16;
  int* const rows32 = sns_y_o + (size_t)S * 16;
  uint8_t* const rows8 = pool8 + (size_t)S * ne;
  for (int i = tid; i < nvalid * 2; i += kThreads) rc_order_o[s0 * 2 + i] = (&s_rc_order[0][0])[i];
  for (int i = tid; i < nvalid * 16; i += kThreads) {
    rc_i_o[s0 * 16 + i] = (&s_rc_i[0][0])[i];
    sns_y_o[s0 * 16 + i] = (&s_sns_y[0][0])[i];
  }
  for (int i = tid; i < kI32Rows * kStreams; i += kThreads) {
    const int r = i / kStreams, k = i % kStreams;
    if (k < nvalid) rows32[(size_t)r * S + s0 + k] = s_rows32[r][k];
  }
  for (int i = tid; i < kU8Rows * kStreams; i += kThreads) {
    const int r = i / kStreams, k = i % kStreams;
    if (k < nvalid) rows8[(size_t)r * S + s0 + k] = s_rows8[r][k];
  }
}

}  // namespace

// payloads [S, nbytes] u8 (nbytes may be 0: every frame is then bad); tables: the table image (parse_kernel.py:
// table_image, kTableBytes); pool32: int32 [S * (ne + 44)], pool8: uint8
// [S * (ne + 4)], the outputs laid out as parse_kernel.py:output_views
// hands them out. ne a multiple of 4 (every LC3 geometry's is).
extern "C" int lc3t_parse(const uint8_t* payloads, const uint8_t* tables, int* pool32,
                          uint8_t* pool8, int S, int nbytes, int ne, int fs_ind, int is_7p5,
                          void* stream) {
  if (S < 1 || nbytes < 0 || ne < 4 || ne % 4 != 0 || fs_ind < 0 || fs_ind > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kTableBytes + align16(kStreams * nbytes) +
                      sizeof(int) * (size_t)kStreams * ne + (size_t)kStreams * ne +
                      (size_t)kStreams * (ne / 2);
  {  // above 48 KB with the static arrays only once allowed (51 KB at 48 kHz / 400 B)
    const cudaError_t err = cudaFuncSetAttribute(
        parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (S + kStreams - 1) / kStreams;
  parse_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      payloads, tables, pool32, pool8, S, nbytes, ne, fs_ind, is_7p5);
  return static_cast<int>(cudaGetLastError());
}
