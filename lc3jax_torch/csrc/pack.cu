// LC3 frame assembly (encoder): the encoder's fields -> frame bytes, one
// thread per stream, the whole frame in the kernel: the backward side-info
// and tail bit writer, the forward range encoder over the TNS and spectral
// symbols, the residual or LSB fill of the gap, and the coder's finish.
//
// Replaces the Pallas kernel lc3jax/coding/pallas_pack.py:_pack_kernel
// (launched by _run_pack_kernel, entries device_pack and encode_bytes_step).
// The scalar structure is the repo's host packer, native/lc3_bitstream.cc:
// pack_one, RangeEnc and the batched side Writer, byte for byte, quirks
// included (the finish writes the cache without its carry; the last head
// byte is partial and may share a byte with the tail; the bit forecast adds
// its 8 cache bits whether or not a cache byte exists). Unlike pack_one it
// does not look the spectral symbols up itself: the bit model's emit_pack
// pass (csrc/bitmodel.cu) gives each tuple's (cum + 1024 * freq) operands,
// as it gave the TPU kernel.
//
// Not ported, because they worked around the TPU's lanes and VMEM: the
// optimistic slot writes with carried-group marks and end-of-frame fix-ups
// (a GPU thread keeps the reference's cache and carry_count), the head ring,
// the i16-pair x_q and 32-per-word residual packing, and the batch-max trip
// bounds (each thread loops to its own lastnz_trunc). The LSB queue is not
// kept either: after the spectral pass, when the budget is known, a second
// walk over the tuples regenerates it in order, as the TPU kernel did.
//
// Like the TPU kernel it trusts the encoder's fields: there is no per-frame
// reject and no host sync. Indices into the tables are clamped, every loop
// has a fixed bound, and every write stays in [0, nbytes) of the stream's
// own row, so garbage fields give garbage bytes and nothing worse.
//
// What bounds it on the H100: each stream is a serial chain of range-coder
// symbols (18 TNS symbols at most, then per tuple its escapes and its final
// symbol) with byte writes; at S = 2048 one thread per stream is 16 blocks
// of 128 threads, about 12% of the 132 SMs. The kernel is latency-bound on
// that chain; its bytes (x_q and the operands, read once) are a few MB. The
// row is written byte by byte straight to device memory; staging it in
// shared memory is left for a later change.
//
// Integer arithmetic throughout: equal to the plain version
// (lc3jax_torch/coding/pack_kernel.py) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// offsets into the int32 table buffer (see lc3jax_torch/coding/pack_kernel.py)
constexpr int kOrderCum = 0;     // [2][8]
constexpr int kOrderFreq = 16;   // [2][8]
constexpr int kCoefCum = 32;     // [8][17]
constexpr int kCoefFreq = 168;   // [8][17]
constexpr int kTableWords = 304;

// rows of the int32 side matrix [kSideRows, S]
enum Side {
  kLastnz, kLsbMode, kGgInd, kNumTns, kOrder0, kOrder1, kPitchPresent, kLtpfActive,
  kPitchIndex, kIndLf, kIndHf, kShapeJ, kGind, kLsInda, kIndexJoint, kBandwidth,
  kNoiseFactor, kNResidual, kRcI, kSideRows = kRcI + 16
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// lc3_bitstream.cc:Writer, batched side bits: backward bits gather LSB first
// in a 64-bit register and leave as whole bytes from the end of the row.
struct Writer {
  uint8_t* buf;
  int len;
  int bp = 0;          // head bytes written
  int side_bytes = 0;  // tail bytes flushed
  uint64_t acc = 0;
  int nacc = 0;

  __device__ void flush_acc() {
    while (nacc >= 8) {
      const int idx = len - 1 - side_bytes;
      if (idx >= 0) buf[idx] = uint8_t(acc & 0xff);
      acc >>= 8;
      nacc -= 8;
      side_bytes++;
    }
  }
  __device__ void uint_backward(uint32_t val, int nbits) {
    // at most 25 bits at once; nacc < 32 before, so acc never overflows
    acc |= (uint64_t(val) & ((uint64_t(1) << nbits) - 1)) << nacc;
    nacc += nbits;
    if (nacc >= 32) flush_acc();
  }
  __device__ void bool_backward(bool bit) { uint_backward(bit ? 1u : 0u, 1); }
  __device__ void byte_forward(uint32_t v) {
    if (bp < len) buf[bp++] = uint8_t(v);
  }
  __device__ void uint_forward(uint32_t val, int nbits) {
    if (bp >= len) return;
    const uint32_t top = (0xff00u >> nbits) & 0xffu;  // the byte's top nbits
    buf[bp] = uint8_t((buf[bp] & ~top) | (val & top));
  }
  __device__ void final_flush() {
    flush_acc();
    const int idx = len - 1 - side_bytes;
    if (nacc > 0 && idx >= 0) buf[idx] |= uint8_t(acc & 0xff);  // may share the head's last byte
  }
  __device__ int nbits_side() const { return 8 * side_bytes + nacc; }
};

// lc3_bitstream.cc:RangeEnc
struct RangeEnc {
  uint32_t low = 0, range = 0x00ffffff;
  int cache = -1, carry = 0, carry_count = 0;

  __device__ void shift(Writer& w) {
    if (low < 0x00ff0000u || carry == 1) {
      if (cache >= 0) w.byte_forward((cache + carry) & 0xff);
      for (; carry_count > 0; carry_count--) w.byte_forward((carry + 0xff) & 0xff);
      cache = int(low >> 16);
      carry = 0;
    } else {
      carry_count++;
    }
    low = (low << 8) & 0x00ffffff;
  }
  __device__ void encode(Writer& w, uint32_t cum, uint32_t freq) {
    const uint32_t r = range >> 10;
    low += r * cum;
    if (low >> 24) carry = 1;
    low &= 0x00ffffff;
    range = r * freq;
    // a valid symbol leaves range >= 64 << 8 after one renorm: at most two
    for (int i = 0; i < 2 && range < 0x10000u; ++i) {
      range <<= 8;
      shift(w);
    }
  }
  __device__ int forecast(const Writer& w) const {
    const int log2r = range ? 31 - __clz(range) : 0;
    return w.bp * 8 + 25 - log2r + 8 + carry_count * 8;
  }
  __device__ void finish(Writer& w) {
    // smallest bits >= 1 with (range >> (24 - bits)) != 0
    int bits = range ? 24 - (31 - __clz(range)) : 24;
    bits = bits < 1 ? 1 : bits;
    uint32_t mask = 0x00ffffffu >> bits;
    uint32_t val = low + mask;
    const uint32_t over1 = val >> 24;
    const uint32_t high = low + range;
    const uint32_t over2 = high >> 24;
    val &= 0x00ffffffu & ~mask;
    if (over1 == over2) {
      if (val + mask >= high) {
        bits++;
        mask >>= 1;
        val = ((low + mask) & 0x00ffffffu) & ~mask;
      }
      if (val < low) carry = 1;
    }
    low = val;
    for (; bits > 0; bits -= 8) shift(w);
    bits += 8;
    if (carry_count > 0) {
      w.byte_forward(uint32_t(cache) & 0xff);
      for (; carry_count > 1; carry_count--) w.byte_forward(0xff);
      w.uint_forward(0xffu >> (8 - bits), bits);
    } else {
      w.uint_forward(uint32_t(cache) & 0xffff, bits);
    }
  }
};

__global__ void pack_kernel(const int* __restrict__ xq_all, const uint8_t* __restrict__ res_all,
                            const int* __restrict__ side, const int* __restrict__ pk,
                            const int* __restrict__ tab, uint8_t* __restrict__ out, int S,
                            int ne, int nbytes, int nbits_bw, int lpcw) {
  __shared__ int s_tab[kTableWords];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int NT = ne / 2;
  const int* xq = xq_all + (long)s * ne;
  const uint8_t* res = res_all + (long)s * ne;
  auto field = [&](int row) { return side[(long)row * S + s]; };

  Writer w;
  w.buf = out + (long)s * nbytes;
  w.len = nbytes;
  for (int i = 0; i < nbytes; ++i) w.buf[i] = 0;

  const int lastnz = clampi(field(kLastnz), 0, ne) & ~1;
  const bool lsb_mode = field(kLsbMode) != 0;
  const int num_tns = clampi(field(kNumTns), 0, 2);
  const int order[2] = {clampi(field(kOrder0), 0, 8), clampi(field(kOrder1), 0, 8)};
  const bool pitch_present = field(kPitchPresent) != 0;
  const int shape_j = field(kShapeJ) & 3;
  const int nbits = nbytes * 8;

  // ---- side info, backward (lc3_bitstream.cc:957-981)
  if (nbits_bw > 0) w.uint_backward(field(kBandwidth), nbits_bw);
  int lastnz_bits = 0;
  while ((1 << lastnz_bits) < NT) lastnz_bits++;  // ceil(log2(ne / 2))
  w.uint_backward((lastnz >> 1) - 1, lastnz_bits);
  w.bool_backward(lsb_mode);
  w.uint_backward(field(kGgInd), 8);
  for (int f = 0; f < num_tns; ++f) w.bool_backward(order[f] != 0);
  w.bool_backward(pitch_present);
  w.uint_backward(field(kIndLf), 5);
  w.uint_backward(field(kIndHf), 5);
  const bool submode_msb = (shape_j >> 1) != 0;
  w.bool_backward(submode_msb);
  const int gain_lsb_bits = shape_j & 1;            // {0, 1, 0, 1}
  const int gain_msb_bits = shape_j < 2 ? 1 : 2;    // {1, 1, 2, 2}
  w.uint_backward(uint32_t(field(kGind)) >> gain_lsb_bits, gain_msb_bits);
  w.bool_backward(field(kLsInda) != 0);
  const uint32_t joint = uint32_t(field(kIndexJoint));
  const int low_bits = submode_msb ? 12 : 13;
  w.uint_backward(joint, low_bits);
  w.uint_backward(joint >> low_bits, 12);
  if (pitch_present) {
    w.bool_backward(field(kLtpfActive) != 0);
    w.uint_backward(field(kPitchIndex), 9);
  }
  w.uint_backward(field(kNoiseFactor), 3);

  // ---- TNS symbols (lc3_bitstream.cc:984-993)
  RangeEnc st;
  for (int f = 0; f < num_tns; ++f) {
    if (order[f] == 0) continue;
    st.encode(w, s_tab[kOrderCum + 8 * lpcw + order[f] - 1],
              s_tab[kOrderFreq + 8 * lpcw + order[f] - 1]);
    for (int k = 0; k < order[f]; ++k) {
      const int rc = clampi(field(kRcI + 8 * f + k), 0, 16);
      st.encode(w, s_tab[kCoefCum + 17 * k + rc], s_tab[kCoefFreq + 17 * k + rc]);
    }
  }

  // ---- spectral tuples (lc3_bitstream.cc:1006-1047): operands from pk
  for (int k = 0; k < lastnz; k += 2) {
    const int n = k >> 1;
    uint32_t a = uint32_t(abs(xq[k]));
    uint32_t b = uint32_t(abs(xq[k + 1]));
    const uint32_t a0 = a, b0 = b;
    int lev = 0;
    for (; lev < 32 && (a >= 4 || b >= 4); ++lev) {
      const int v = pk[((long)(lev < 3 ? lev : 3) * NT + n) * S + s];
      st.encode(w, v & 1023, uint32_t(v) >> 10);
      if (!(lsb_mode && lev == 0)) {
        w.bool_backward(a & 1);
        w.bool_backward(b & 1);
      }
      a >>= 1;
      b >>= 1;
    }
    const int v = pk[((long)4 * NT + n) * S + s];
    st.encode(w, v & 1023, uint32_t(v) >> 10);
    const bool halve = lsb_mode && lev > 0;
    if ((halve ? a0 >> 1 : a0) > 0) w.bool_backward(xq[k] <= 0);
    if ((halve ? b0 >> 1 : b0) > 0) w.bool_backward(xq[k + 1] <= 0);
  }

  // ---- residual or LSB bits in the gap (lc3_bitstream.cc:1049-1072)
  const int budget = max(0, nbits - (w.nbits_side() + st.forecast(w)));
  if (!lsb_mode) {
    // nonzero lines in order, as the decoder consumes them
    const int n_res = min(budget, field(kNResidual));
    int emitted = 0;
    for (int k = 0; k < ne && emitted < n_res; ++k) {
      if (xq[k] != 0) {
        w.bool_backward(res[k] != 0);
        emitted++;
      }
    }
  } else {
    // the LSB queue, regenerated in order: per escaped tuple lsb0, the sign
    // of a line its halving zeroed, lsb1, the same; the first `budget` go
    int queued = 0;
    auto push = [&](bool bit) {
      if (queued < budget) w.bool_backward(bit);
      queued++;
    };
    for (int k = 0; k < lastnz && queued < budget; k += 2) {
      const uint32_t a0 = uint32_t(abs(xq[k]));
      const uint32_t b0 = uint32_t(abs(xq[k + 1]));
      if (a0 < 4 && b0 < 4) continue;  // no escape: nothing queued
      push(a0 & 1);
      if ((a0 >> 1) == 0 && xq[k] != 0) push(xq[k] <= 0);
      push(b0 & 1);
      if ((b0 >> 1) == 0 && xq[k + 1] != 0) push(xq[k + 1] <= 0);
    }
  }
  st.finish(w);
  w.final_flush();
}

}  // namespace

// xq: [S, ne] i32; res: [S, ne] u8 (0/1); side: [kSideRows = 34, S] i32 (the
// order of enum Side); pk: [5 * ne / 2, S] i32 (bitmodel.cu's emit_pack);
// tab: [304] i32 (AC_TNS_ORDER_CUMFREQ, AC_TNS_ORDER_FREQ, AC_TNS_COEF_CUMFREQ,
// AC_TNS_COEF_FREQ); out: [S, nbytes] u8, every byte written.
extern "C" int lc3t_pack(const int* xq, const uint8_t* res, const int* side, const int* pk,
                         const int* tab, uint8_t* out, int S, int ne, int nbytes,
                         int nbits_bw, int lpcw, void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  pack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xq, res, side, pk, tab, out, S, ne, nbytes, nbits_bw, lpcw);
  return static_cast<int>(cudaGetLastError());
}
