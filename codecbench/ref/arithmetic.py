"""Arithmetic (range) decoder for TNS + spectral data.

Mirrors reference decoder/arithmetic_codec.rs: a 24-bit range decoder with
byte renormalisation; symbols are drawn from the spec's static frequency
models (tables.AC_*). Escape symbols (sym==16) raise the amplitude level; in
lsb_mode level-0 LSBs are deferred to the residual pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import tables as T
from .bitstream import BufferReader
from .side_info import SideInfo


class ArithmeticDecodeError(Exception):
    """Raised on a corrupt arithmetic-coded payload; routes frame to PLC."""


@dataclass
class ArithmeticData:
    reflect_coef_order: list
    reflect_coef_ints: list
    residual_bits: list
    noise_filling_seed: int
    is_zero_frame: bool
    frame_num_bits: int


class _RangeDecoder:
    __slots__ = ("low", "rng")

    def __init__(self, buf: bytes, reader: BufferReader):
        self.low = reader.read_head_u24(buf)
        self.rng = 0x00FFFFFF

    def decode(self, buf: bytes, reader: BufferReader, cum_freq, sym_freq) -> int:
        tmp = self.rng >> 10
        if self.low >= (tmp << 10):
            raise ArithmeticDecodeError(f"ac_low {self.low} out of range")
        val = len(cum_freq) - 1
        while self.low < tmp * int(cum_freq[val]):
            val -= 1
        self.low -= tmp * int(cum_freq[val])
        self.rng = tmp * int(sym_freq[val])
        while self.rng < 0x10000:
            self.low = ((self.low << 8) & 0x00FFFFFF) + reader.read_head_byte(buf)
            self.rng <<= 8
        return val


def decode(
    buf: bytes,
    reader: BufferReader,
    fs_ind: int,
    ne: int,
    side: SideInfo,
    is_7p5ms: bool,
    x: list,
) -> ArithmeticData:
    nbits = len(buf) * 8
    st = _RangeDecoder(buf, reader)

    tns_idx, tns_order = _decode_tns(buf, reader, side, st, nbits, is_7p5ms)

    save_lev = [0] * ne
    _decode_spectrum(buf, reader, side, nbits, fs_ind, ne, st, x, save_lev)

    for k in range(side.lastnz, ne):
        x[k] = 0

    residual_bits = _decode_residual(buf, reader, side, st, nbits, ne, x, save_lev)

    seed = 0
    for k in range(ne):
        seed += abs(x[k]) * k
    seed &= 0xFFFF

    is_zero_frame = (
        side.lastnz == 2 and x[0] == 0 and x[1] == 0 and side.global_gain_index == 0
    )

    return ArithmeticData(
        reflect_coef_order=tns_order,
        reflect_coef_ints=tns_idx,
        residual_bits=residual_bits,
        noise_filling_seed=seed,
        is_zero_frame=is_zero_frame,
        frame_num_bits=nbits,
    )


def _decode_tns(buf, reader, side, st, nbits, is_7p5ms):
    max_bits = 360 if is_7p5ms else 480
    lpc_weighting = 1 if nbits < max_bits else 0
    tns_idx = [0] * (T.TNS_NUMFILTERS_MAX * T.MAXLAG)
    tns_order = list(side.reflect_coef_order_ari_input)
    for f in range(side.num_tns_filters):
        if tns_order[f] > 0:
            order = st.decode(
                buf, reader, T.AC_TNS_ORDER_CUMFREQ[lpc_weighting], T.AC_TNS_ORDER_FREQ[lpc_weighting]
            )
            tns_order[f] = order + 1
            for k in range(tns_order[f]):
                tns_idx[f * 8 + k] = st.decode(
                    buf, reader, T.AC_TNS_COEF_CUMFREQ[k], T.AC_TNS_COEF_FREQ[k]
                )
    return tns_idx, tns_order


def _decode_spectrum(buf, reader, side, nbits, fs_ind, ne, st, x, save_lev):
    rate_flag = 512 if nbits > (160 + fs_ind * 160) else 0
    c = 0
    lookup = T.AC_SPEC_LOOKUP
    cumfreq = T.AC_SPEC_CUMFREQ
    freq = T.AC_SPEC_FREQ
    for k in range(0, side.lastnz, 2):
        t = c + rate_flag + (256 if k > ne // 2 else 0)
        xk = 0
        xk1 = 0
        sym = 0
        lev = 0
        while lev < 14:
            pki = int(lookup[t + min(lev, 3) * 1024])
            sym = st.decode(buf, reader, cumfreq[pki], freq[pki])
            if sym < 16:
                break
            if not side.lsb_mode or lev > 0:
                xk += int(reader.read_tail_bool(buf)) << lev
                xk1 += int(reader.read_tail_bool(buf)) << lev
            lev += 1
        if side.lsb_mode:
            save_lev[k] = lev
        a = sym & 0x3
        b = sym >> 2
        xk += a << lev
        xk1 += b << lev
        if xk > 0 and reader.read_tail_bool(buf):
            xk = -xk
        if xk1 > 0 and reader.read_tail_bool(buf):
            xk1 = -xk1
        x[k] = xk
        x[k + 1] = xk1
        lev = min(lev, 3)
        t = 1 + (a + b) * (lev + 1) if lev <= 1 else 12 + lev
        c = (c & 15) * 16 + t


def _num_residual_bits(reader, st, total_bits) -> int:
    nbits_side = reader.tail - 8
    nbits_ari = (reader.head + 1 - 3) * 8 + 25 - math.floor(math.log2(st.rng))
    if total_bits < nbits_side + nbits_ari:
        raise ArithmeticDecodeError("negative residual bit count")
    return total_bits - nbits_side - nbits_ari


def _decode_residual(buf, reader, side, st, nbits, ne, x, save_lev):
    nbits_residual = _num_residual_bits(reader, st, nbits)
    residual_bits = []
    if not side.lsb_mode:
        for k in range(ne):
            if x[k] != 0:
                if len(residual_bits) == nbits_residual:
                    break
                residual_bits.append(reader.read_tail_bool(buf))
    else:
        nres = nbits_residual

        def read_bit(idx: int) -> tuple[bool, int]:
            nonlocal nres
            if nres == 0:
                return False, idx
            bit = reader.read_tail_bool(buf)
            nres -= 1
            if bit:
                if x[idx] > 0:
                    x[idx] += 1
                elif x[idx] < 0:
                    x[idx] -= 1
                else:
                    if nres == 0:
                        return False, idx
                    bit2 = reader.read_tail_bool(buf)
                    nres -= 1
                    x[idx] = -1 if bit2 else 1
            return True, idx

        for k in range(0, side.lastnz, 2):
            if save_lev[k] > 0:
                ok, _ = read_bit(k)
                if not ok:
                    break
                ok, _ = read_bit(k + 1)
                if not ok:
                    break
    return residual_bits
