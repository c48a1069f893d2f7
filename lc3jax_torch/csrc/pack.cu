// LC3 frame assembly (encoder): the encoder's fields -> frame bytes, the
// whole frame in one launch, a warp a stream and 16 streams a block: the
// backward side-info and tail bit writer, the forward range encoder over the
// TNS and spectral symbols, the residual or LSB fill of the gap, and the
// coder's finish.
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
// (a GPU lane keeps the reference's cache and carry_count), the head ring,
// the i16-pair x_q and 32-per-word residual packing, and the batch-max trip
// bounds (each lane loops to its own lastnz_trunc). The LSB queue is not
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
// symbol) with byte writes, so the kernel is bound by the chains; its bytes
// (x_q and the operands, read once) are a few MB. On the previous design
// (commit 308f410: one thread a stream, its row zeroed and written byte by
// byte in device memory, x_q and the operands read there) the symbol loop
// took three quarters of the kernel at about 1,000 cycles a symbol, and the
// row zeroing a tenth (tools/kernel_phases.py); a lane a stream with every
// operand on chip still diverged at every escape and renormalisation. So here a warp a stream, 16
// streams a block (128 blocks of 512 threads at S = 2048): the block copies
// its 16 x_q rows and residual bits (16-byte loads) and the operand rows of
// its coded tuples (eight loads in flight a thread) into shared memory and
// zeroes its 16 output rows there; lane 0 of each warp codes its stream's
// frame into its row with no lane to diverge from, the SM interleaving the
// block's 16 chains; the block writes the rows out as one linear copy (a
// block's rows are contiguous in the output).
//
// Integer arithmetic throughout: equal to the plain version
// (lc3jax_torch/coding/pack_kernel.py) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_copy.cuh"

namespace {

using lc3t::align16;
using lc3t::block_copy;

constexpr int kStreams = 16;              // streams a block, a warp each
constexpr int kThreads = 32 * kStreams;

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

// One stream's frame into its zeroed row (shared memory): xq and res its
// staged rows, ops its column of the staged operands ([5][NT] at a stride of
// kStreams), side_s its column of the side matrix (a stride of S).
__device__ void code_frame(uint8_t* row, const int* xq, const uint8_t* res, const int* ops,
                           const int* side_s, const int* s_tab, int S, int ne, int nbytes,
                           int nbits_bw, int lpcw) {
  const int NT = ne / 2;
  auto field = [&](int r) { return side_s[(size_t)r * S]; };
  auto operand = [&](int r, int n) { return ops[(r * NT + n) * kStreams]; };

  Writer w;
  w.buf = row;
  w.len = nbytes;

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
      const int v = operand(lev < 3 ? lev : 3, n);
      st.encode(w, v & 1023, uint32_t(v) >> 10);
      if (!(lsb_mode && lev == 0)) {
        w.bool_backward(a & 1);
        w.bool_backward(b & 1);
      }
      a >>= 1;
      b >>= 1;
    }
    const int v = operand(4, n);
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

__global__ void __launch_bounds__(kThreads) pack_kernel(
    const int* __restrict__ xq_all, const uint8_t* __restrict__ res_all,
    const int* __restrict__ side, const int* __restrict__ pk, const int* __restrict__ tab,
    uint8_t* __restrict__ out, int S, int ne, int nbytes, int nbits_bw, int lpcw) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_tab[kTableWords];
  __shared__ int s_nt;  // the block's most coded tuples
  const int NT = ne / 2;
  int* xs = reinterpret_cast<int*>(smem);  // x_q rows [kStreams][ne]
  int* pks = xs + kStreams * ne;           // operands [5][NT][kStreams]
  uint8_t* rows = reinterpret_cast<uint8_t*>(pks + 5 * NT * kStreams);  // [kStreams][nbytes]
  uint8_t* res_s = rows + align16(kStreams * nbytes);                  // [kStreams][ne]

  const int s0 = blockIdx.x * kStreams;
  const int nvalid = min(kStreams, S - s0);
  const int tid = threadIdx.x;

  // ---- stage: tables, x_q rows, residual bits; the output rows start at 0
  if (tid == 0) s_nt = 0;
  for (int i = tid; i < kTableWords; i += kThreads) s_tab[i] = tab[i];
  block_copy(reinterpret_cast<uint8_t*>(xs), reinterpret_cast<const uint8_t*>(xq_all + (size_t)s0 * ne),
             nvalid * ne * 4);
  block_copy(res_s, res_all + (size_t)s0 * ne, nvalid * ne);
  for (int i = tid; i < align16(kStreams * nbytes) / 16; i += kThreads)
    reinterpret_cast<uint4*>(rows)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid < nvalid) atomicMax(&s_nt, clampi(side[(size_t)kLastnz * S + s0 + tid], 0, ne) >> 1);
  __syncthreads();
  // the operand rows of the tuples any stream of the block codes, 64 bytes
  // a (row, tuple); eight loads in flight a thread
  const int per_row = s_nt * kStreams;
  for (int j0 = tid; j0 < 5 * per_row; j0 += 8 * kThreads) {
    int v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + q * kThreads;
      const int r = j / per_row, rem = j - r * per_row;
      const int n = rem / kStreams, c = rem % kStreams;
      v[q] = j < 5 * per_row && c < nvalid ? pk[(size_t)(r * NT + n) * S + s0 + c] : 0;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + q * kThreads;
      const int r = j / per_row, rem = j - r * per_row;
      if (j < 5 * per_row) pks[r * NT * kStreams + rem] = v[q];
    }
  }
  __syncthreads();

  // lane 0 of warp u codes stream s0 + u
  const int u = tid >> 5;
  if ((tid & 31) == 0 && u < nvalid)
    code_frame(rows + u * nbytes, xs + u * ne, res_s + u * ne, pks + u, side + s0 + u, s_tab, S,
               ne, nbytes, nbits_bw, lpcw);
  __syncthreads();
  block_copy(out + (size_t)s0 * nbytes, rows, nvalid * nbytes);
}

}  // namespace

// xq: [S, ne] i32; res: [S, ne] u8 (0/1); side: [kSideRows = 34, S] i32 (the
// order of enum Side); pk: [5 * ne / 2, S] i32 (bitmodel.cu's emit_pack);
// tab: [304] i32 (AC_TNS_ORDER_CUMFREQ, AC_TNS_ORDER_FREQ, AC_TNS_COEF_CUMFREQ,
// AC_TNS_COEF_FREQ); out: [S, nbytes] u8, every byte written.
extern "C" int lc3t_pack(const int* xq, const uint8_t* res, const int* side, const int* pk,
                         const int* tab, uint8_t* out, int S, int ne, int nbytes,
                         int nbits_bw, int lpcw, void* stream) {
  if (S < 1 || ne < 2 || nbytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * (size_t)kStreams * (ne + 5 * (ne / 2)) +
                      align16(kStreams * nbytes) + (size_t)kStreams * ne;
  {  // above 48 KB only once allowed (98 KB at 48 kHz / 10 ms / 150 B)
    const cudaError_t err = cudaFuncSetAttribute(
        pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (S + kStreams - 1) / kStreams;
  pack_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xq, res, side, pk, tab, out, S, ne, nbytes, nbits_bw, lpcw);
  return static_cast<int>(cudaGetLastError());
}
