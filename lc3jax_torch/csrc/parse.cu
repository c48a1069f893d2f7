// LC3 frame parser: raw frame bytes -> ParsedFrames fields, one thread per
// stream, the whole frame in the kernel.
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
// no SIMD, no frame interleaving. The symbol search counts the cumfreq row
// entries <= low / (range >> 10) by compare, over the raw spec tables
// (6,752 int32, 27 KB, uploaded once and read through the read-only cache).
//
// What bounds it on the H100: each stream is a serial chain of range-decoder
// symbols (up to ne/2 tuples, each one or more dependent symbol decodes
// with byte pulls), and at S = 2048 one thread per stream is only 16 blocks
// of 128 threads, about 12% of the 132 SMs. The kernel is latency-bound on
// that chain; this design does not try to hide it (a later change can split
// a stream's work or run more streams per launch).
//
// Every output field of every stream is written on every path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// offsets into the int32 table buffer (see lc3jax_torch/coding/parse_kernel.py)
constexpr int kSpecCum = 0;        // [64][17]
constexpr int kSpecFreq = 1088;    // [64][17]
constexpr int kLookup = 2176;      // [4096]
constexpr int kOrderCum = 6272;    // [2][8]
constexpr int kOrderFreq = 6288;   // [2][8]
constexpr int kCoefCum = 6304;     // [8][17]
constexpr int kCoefFreq = 6440;    // [8][17]
constexpr int kMpvq = 6576;        // [16][11]

struct Frame {
  const uint8_t* buf;
  const int* tab;
  int nbytes;
  int cursor = 0;   // tail bit cursor
  bool tail_err = false;
  int head = 0;     // head byte cursor
  bool err = false;
  uint32_t low = 0, rng = 0;

  __device__ int byte_at(int i) const {
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

  // Range-decode one symbol over a cumfreq/freq row of K entries.
  __device__ int decode(const int* cum, const int* freq, int K) {
    const uint32_t tmp = rng >> 10;
    if (low >= (tmp << 10)) err = true;
    int val = 0;
    for (int j = 1; j < K; ++j) val += low >= tmp * uint32_t(__ldg(cum + j)) ? 1 : 0;
    low -= tmp * uint32_t(__ldg(cum + val));
    rng = tmp * uint32_t(__ldg(freq + val));
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

__device__ void mpvq_deenum(const int* offsets, int dim, int k_val, int ls_ind,
                            int ind, int* y) {
  int lead = ls_ind == 0 ? 1 : -1;
  int k_max = k_val;
  for (int p = 0; p < dim; ++p) {
    const int* row = offsets + 11 * (dim - 1 - p);
    if (ind == 0) {
      y[p] = k_max * lead;
      return;
    }
    int cnt = 0;
    for (int j = 1; j < 11; ++j) cnt += ind >= __ldg(row + j) ? 1 : 0;
    const int k_acc = k_max < cnt ? k_max : cnt;
    const int ind_new = ind - __ldg(row + k_acc);
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

__global__ void parse_kernel(
    const uint8_t* __restrict__ payloads, const int* __restrict__ tab,
    int* __restrict__ save_lev_t, int* __restrict__ x_int, uint8_t* __restrict__ lsb_mode_o,
    int* __restrict__ gg_ind_o, int* __restrict__ rc_order_o, int* __restrict__ rc_i_o,
    int* __restrict__ bandwidth_o, int* __restrict__ noise_factor_o,
    int* __restrict__ nf_seed_o, uint8_t* __restrict__ zero_frame_o,
    uint8_t* __restrict__ residual_bits_o, int* __restrict__ n_residual_o,
    int* __restrict__ sns_y_o, int* __restrict__ sns_shape_o, int* __restrict__ sns_gind_o,
    int* __restrict__ sns_ind_lf_o, int* __restrict__ sns_ind_hf_o,
    uint8_t* __restrict__ ltpf_active_o, int* __restrict__ pitch_index_o,
    uint8_t* __restrict__ bad_frame_o, int S, int nbytes, int ne, int fs_ind,
    int is_7p5) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  Frame f;
  f.buf = payloads + (size_t)s * nbytes;
  f.tab = tab;
  f.nbytes = nbytes;
  const int nbits = nbytes * 8;
  int* x = x_int + (size_t)s * ne;

  // ---------------- side info (side_info_reader.rs:29-103)
  bool bad = false;
  const int kNbitsBw[5] = {0, 1, 2, 2, 3};
  const int nbits_bw = kNbitsBw[fs_ind];
  int p_bw = 0;
  if (nbits_bw > 0) {
    p_bw = int(f.read(nbits_bw));
    if (p_bw > fs_ind) { bad = true; p_bw = fs_ind; }
  }
  int lastnz_bits = 0;
  while ((1 << lastnz_bits) < ne / 2) ++lastnz_bits;
  int lastnz = (int(f.read(lastnz_bits)) + 1) << 1;
  if (lastnz > ne) { bad = true; lastnz = ne; }
  const bool lsb_mode = f.read(1) != 0;
  const int gg_ind = int(f.read(8));
  const int num_tns = p_bw < 3 ? 1 : 2;
  const int rc_flag0 = int(f.read(1));
  const int rc_flag1 = int(f.read_masked(1, num_tns == 2));
  const bool pitch_present = f.read(1) != 0;
  const int ind_lf = int(f.read(5));
  const int ind_hf = int(f.read(5));
  const int submode_msb = int(f.read(1));
  const uint32_t g2 = f.read(2, submode_msb == 0 ? 1 : 2, true);
  int g_ind = submode_msb == 0 ? int(g2 & 1u) : int(g2 & 3u);
  const int ls_inda = int(f.read(1));
  const bool msb0 = submode_msb == 0;
  int tmp = int(f.read(25, msb0 ? 25 : 24, true));
  if (!msb0) tmp &= 0xFFFFFF;
  if (msb0 ? tmp >= 33460056 : tmp >= 16708096) bad = true;
  int submode_lsb, idx_a, idx_b = 0, ls_indb = 0;
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
  const int shape_j = (submode_msb << 1) + submode_lsb;
  const bool ltpf_active = f.read_masked(1, pitch_present) != 0;
  const int pitch_index = int(f.read_masked(9, pitch_present));
  const int noise_factor = int(f.read(3));
  bad = bad || f.tail_err;

  // ---------------- arithmetic decoder init (arithmetic_codec.rs:57-65)
  {
    const uint32_t b0 = f.head_byte(), b1 = f.head_byte(), b2 = f.head_byte();
    f.low = (b0 << 16) | (b1 << 8) | b2;
    f.rng = 0x00FFFFFFu;
  }

  // ---------------- TNS order and coefficients (arithmetic_codec.rs:307-344)
  const int lpcw = nbits < (is_7p5 ? 360 : 480) ? 1 : 0;
  int rc_order[2] = {rc_flag0, rc_flag1};
  int rc_i[16];
  for (int k = 0; k < 16; ++k) rc_i[k] = 0;
  for (int fi = 0; fi < 2; ++fi) {
    if (!(fi < num_tns && rc_order[fi] > 0)) continue;
    rc_order[fi] = f.decode(tab + kOrderCum + 8 * lpcw, tab + kOrderFreq + 8 * lpcw, 8) + 1;
    for (int k = 0; k < rc_order[fi]; ++k)
      rc_i[fi * 8 + k] = f.decode(tab + kCoefCum + 17 * k, tab + kCoefFreq + 17 * k, 17);
  }

  // ---------------- spectral tuples (arithmetic_codec.rs:211-305)
  const int rate_flag = nbits > (160 + fs_ind * 160) ? 512 : 0;
  const int nlast = bad ? 0 : lastnz;  // tuples past lastnz (or all, if bad) are no-ops
  int c = 0;
  for (int n = 0; n < ne; n += 2) {
    if (n >= nlast) {
      x[n] = 0;
      x[n + 1] = 0;
      save_lev_t[(size_t)(n >> 1) * S + s] = 0;
      continue;
    }
    const int t = c + rate_flag + (n > ne / 2 ? 256 : 0);
    int xk = 0, xk1 = 0, sym = 0, lev = 0;
    for (int level = 0; level < 14; ++level) {
      int li = t + (lev < 3 ? lev : 3) * 1024;
      li = li < 0 ? 0 : (li > 4095 ? 4095 : li);
      const int pki = __ldg(tab + kLookup + li);
      sym = f.decode(tab + kSpecCum + 17 * pki, tab + kSpecFreq + 17 * pki, 17);
      if (sym < 16) break;
      if (!lsb_mode || lev > 0) {
        xk += f.tail_bit(f.cursor, true, f.err) << lev;
        xk1 += f.tail_bit(f.cursor, true, f.err) << lev;
      }
      ++lev;
    }
    save_lev_t[(size_t)(n >> 1) * S + s] = lsb_mode ? lev : 0;
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

  // ---------------- residual bits (arithmetic_codec.rs:160-208, 390-405)
  int log2rng = 0;
  for (int k = 1; k <= 24; ++k) log2rng += f.rng >= (1u << k) ? 1 : 0;
  const int nbits_side = f.cursor - 8;
  const int nbits_ari = (f.head + 1 - 3) * 8 + 25 - log2rng;
  const bool neg_budget = nbits < nbits_side + nbits_ari;
  int nres_avail = nbits - nbits_side - nbits_ari;
  nres_avail = nres_avail > 0 ? nres_avail : 0;

  uint8_t* res = residual_bits_o + (size_t)s * ne;
  int bitpos = -1, n_res = 0;
  bool err = f.err;
  for (int k = 0; k < ne; ++k) {
    const bool nz = x[k] != 0;
    bitpos += nz ? 1 : 0;
    const bool can_read = nz && bitpos < nres_avail && !lsb_mode;
    int bit = 0;
    if (can_read) {
      const int rcur = f.cursor + bitpos;
      const int byte_index = rcur >> 3;
      bit = (f.byte_at(nbytes - 1 - byte_index) >> (rcur & 7)) & 1;
      if (nbytes - f.head - byte_index + 2 < 0) err = true;
      n_res += 1;
    }
    res[k] = uint8_t(bit);
  }
  bad = bad || err || neg_budget;

  // ---------------- LSB refinement (sequential, budgeted)
  if (lsb_mode && !bad) {
    int cur = f.cursor, budget = nres_avail;
    bool lerr = false;
    for (int n = 0; n < lastnz; n += 2) {
      if (save_lev_t[(size_t)(n >> 1) * S + s] <= 0) continue;
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

  uint32_t seed = 0;
  for (int k = 0; k < ne; ++k) {
    const int v = x[k];
    seed += uint32_t(v < 0 ? -v : v) * uint32_t(k);
  }
  const bool zero_frame = lastnz == 2 && x[0] == 0 && x[1] == 0 && gg_ind == 0;
  if (bad)
    for (int k = 0; k < ne; ++k) x[k] = 0;

  // ---------------- MPVQ de-enumeration (spectral_noise_shaping.rs:155-199)
  int y[16];
  for (int k = 0; k < 16; ++k) y[k] = 0;
  const int* mpvq = tab + kMpvq;
  if (shape_j <= 1) {
    mpvq_deenum(mpvq, 10, 10, ls_inda, idx_a, y);
    if (shape_j == 0) mpvq_deenum(mpvq, 6, 1, ls_indb, idx_b, y + 10);
  } else {
    mpvq_deenum(mpvq, 16, shape_j == 2 ? 8 : 6, ls_inda, idx_a, y);
  }

  // ---------------- outputs: every field, every stream
  lsb_mode_o[s] = lsb_mode;
  gg_ind_o[s] = gg_ind;
  rc_order_o[2 * s + 0] = rc_order[0];
  rc_order_o[2 * s + 1] = rc_order[1];
  for (int k = 0; k < 16; ++k) rc_i_o[16 * s + k] = rc_i[k];
  bandwidth_o[s] = p_bw;
  noise_factor_o[s] = noise_factor;
  nf_seed_o[s] = bad ? 0 : int(seed & 0xFFFFu);
  zero_frame_o[s] = zero_frame;
  n_residual_o[s] = lsb_mode ? 0 : n_res;
  for (int k = 0; k < 16; ++k) sns_y_o[16 * s + k] = y[k];
  sns_shape_o[s] = shape_j;
  sns_gind_o[s] = g_ind;
  sns_ind_lf_o[s] = ind_lf;
  sns_ind_hf_o[s] = ind_hf;
  ltpf_active_o[s] = ltpf_active && !bad;
  pitch_index_o[s] = bad ? 0 : pitch_index;
  bad_frame_o[s] = bad;
}

}  // namespace

// payloads [S, nbytes] u8; tab: the int32 table buffer; save_lev_t [ne/2, S]
// i32 scratch; outputs in ParsedFrames order, [S, ...] row-major (bool
// fields as one byte each).
extern "C" int lc3t_parse(
    const uint8_t* payloads, const int* tab, int* save_lev_t, int* x_int,
    uint8_t* lsb_mode, int* gg_ind, int* rc_order, int* rc_i, int* bandwidth,
    int* noise_factor, int* nf_seed, uint8_t* zero_frame, uint8_t* residual_bits,
    int* n_residual, int* sns_y, int* sns_shape, int* sns_gind, int* sns_ind_lf,
    int* sns_ind_hf, uint8_t* ltpf_active, int* pitch_index, uint8_t* bad_frame,
    int S, int nbytes, int ne, int fs_ind, int is_7p5, void* stream) {
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  parse_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      payloads, tab, save_lev_t, x_int, lsb_mode, gg_ind, rc_order, rc_i, bandwidth,
      noise_factor, nf_seed, zero_frame, residual_bits, n_residual, sns_y, sns_shape,
      sns_gind, sns_ind_lf, sns_ind_hf, ltpf_active, pitch_index, bad_frame, S, nbytes,
      ne, fs_ind, is_7p5);
  return static_cast<int>(cudaGetLastError());
}
