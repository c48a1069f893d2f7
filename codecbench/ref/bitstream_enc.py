"""Frame assembly: backward side-info bits + forward arithmetic coder
(reference encoder/bitstream_encoding.rs + encoder/buffer_writer.rs).

Side info is written bit-by-bit from the last byte backwards; the range
coder (24-bit low/range with carry/cache propagation) writes bytes from the
front; residual or LSB bits fill the remaining gap.
"""

from __future__ import annotations

import math

import numpy as np

from . import tables as T

F32 = np.float32


class BackForthWriter:
    """Dual-ended bit writer (buffer_writer.rs:4-66)."""

    def __init__(self, nbytes: int):
        self.buf = bytearray(nbytes)
        self.bp = 0
        self.bp_side = nbytes - 1
        self.mask_side = 1

    def write_bool_backward(self, bit: bool) -> None:
        if bit:
            self.buf[self.bp_side] |= self.mask_side
        else:
            self.buf[self.bp_side] &= ~self.mask_side & 0xFF
        if self.mask_side == 0x80:
            self.mask_side = 1
            self.bp_side -= 1
        else:
            self.mask_side <<= 1

    def write_uint_backward(self, val: int, num_bits: int) -> None:
        for _ in range(num_bits):
            self.write_bool_backward(val & 1 == 1)
            val >>= 1

    def write_byte_forward(self, val: int) -> None:
        self.buf[self.bp] = val & 0xFF
        self.bp += 1

    def write_uint_forward(self, val: int, num_bits: int) -> None:
        # writes the high bits of `val`'s low byte into buf[bp] without
        # advancing bp (buffer_writer.rs:42-53)
        mask = 0x80
        for _ in range(num_bits):
            if val & mask:
                self.buf[self.bp] |= mask
            else:
                self.buf[self.bp] &= ~mask & 0xFF
            mask >>= 1

    def nbits_side_written(self, nbits: int) -> int:
        return nbits - (8 * self.bp_side + 8 - int(math.log2(self.mask_side)))


class BitstreamEncoder:
    def __init__(self, ne: int):
        self.ne = ne

    def encode(
        self,
        bandwidth_ind: int,
        nbits_bandwidth: int,
        sns,
        tns,
        ltpf,
        spec,
        residual_bits: list,
        noise_factor: int,
        x_q: np.ndarray,
        nbytes: int,
    ) -> bytes:
        self.nbits = nbytes * 8
        w = BackForthWriter(nbytes)
        self.w = w
        self.lsbs: list[int] = []

        # ---- side info (tail, backward)
        if nbits_bandwidth > 0:
            w.write_uint_backward(bandwidth_ind, nbits_bandwidth)
        lastnz_bits = math.ceil(math.log2(self.ne / 2.0))
        w.write_uint_backward((spec.lastnz_trunc >> 1) - 1, lastnz_bits)
        w.write_bool_backward(spec.lsb_mode)
        w.write_uint_backward(spec.gg_ind, 8)
        for f in range(tns.num_tns_filters):
            w.write_bool_backward(tns.rc_order[f] != 0)
        w.write_bool_backward(ltpf.pitch_present)
        # SNS VQ stage 1 + 2
        w.write_uint_backward(sns.ind_lf, 5)
        w.write_uint_backward(sns.ind_hf, 5)
        submode_msb = (sns.shape_j >> 1) != 0
        w.write_bool_backward(submode_msb)
        gain_msbs = sns.gind >> int(T.SNS_GAIN_LSB_BITS[sns.shape_j])
        w.write_uint_backward(gain_msbs, int(T.SNS_GAIN_MSB_BITS[sns.shape_j]))
        w.write_bool_backward(sns.ls_inda != 0)
        if not submode_msb:
            w.write_uint_backward(sns.index_joint_j, 13)
            w.write_uint_backward(sns.index_joint_j >> 13, 12)
        else:
            w.write_uint_backward(sns.index_joint_j, 12)
            w.write_uint_backward(sns.index_joint_j >> 12, 12)
        if ltpf.pitch_present:
            w.write_bool_backward(ltpf.ltpf_active)
            w.write_uint_backward(ltpf.pitch_index, 9)
        w.write_uint_backward(noise_factor, 3)

        # ---- arithmetic coder (head, forward)
        self.low = 0
        self.range = 0x00FFFFFF
        self.cache = -1
        self.carry = 0
        self.carry_count = 0

        self._tns_data(tns)
        self._spectral_data(spec, x_q)
        self._residual_and_finish(spec.lsb_mode, residual_bits)

        return bytes(w.buf)

    # ------------------------------------------------------------- ac coder
    def _ac_shift(self) -> None:
        if self.low < 0x00FF0000 or self.carry == 1:
            if self.cache >= 0:
                self.w.write_byte_forward((self.cache + self.carry) & 0xFF)
            while self.carry_count > 0:
                self.w.write_byte_forward((self.carry + 0xFF) & 0xFF)
                self.carry_count -= 1
            self.cache = self.low >> 16
            self.carry = 0
        else:
            self.carry_count += 1
        self.low = (self.low << 8) & 0x00FFFFFF

    def _ac_encode(self, cum_freq: int, sym_freq: int) -> None:
        r = self.range >> 10
        self.low += r * cum_freq
        if self.low >> 24 != 0:
            self.carry = 1
        self.low &= 0x00FFFFFF
        self.range = r * sym_freq
        while self.range < 0x10000:
            self.range <<= 8
            self._ac_shift()

    def _ac_finish(self) -> None:
        bits = 1
        while (self.range >> (24 - bits)) == 0:
            bits += 1
        mask = 0x00FFFFFF >> bits
        val = self.low + mask
        over1 = val >> 24
        high = self.low + self.range
        over2 = high >> 24
        val &= 0x00FFFFFF & ~mask
        if over1 == over2:
            if (val + mask) >= high:
                bits += 1
                mask >>= 1
                val = ((self.low + mask) & 0x00FFFFFF) & ~mask
            if val < self.low:
                self.carry = 1
        self.low = val
        while bits > 0:
            self._ac_shift()
            bits -= 8
        bits += 8
        if self.carry_count > 0:
            self.w.write_byte_forward(self.cache & 0xFF)
            while self.carry_count > 1:
                self.w.write_byte_forward(0xFF)
                self.carry_count -= 1
            self.w.write_uint_forward(0xFF >> (8 - bits), bits)
        else:
            self.w.write_uint_forward(self.cache & 0xFFFF, bits)

    def _nbits_ari_forecast(self) -> int:
        nbits_ari = self.w.bp * 8
        nbits_ari += 25 - int(math.floor(math.log2(self.range)))
        if self.carry >= 0:
            nbits_ari += 8
        if self.carry_count > 0:
            nbits_ari += self.carry_count * 8
        return nbits_ari

    # --------------------------------------------------------------- payload
    def _tns_data(self, tns) -> None:
        lw = tns.lpc_weighting
        for f in range(tns.num_tns_filters):
            if tns.rc_order[f] > 0:
                self._ac_encode(
                    int(T.AC_TNS_ORDER_CUMFREQ[lw][tns.rc_order[f] - 1]),
                    int(T.AC_TNS_ORDER_FREQ[lw][tns.rc_order[f] - 1]),
                )
                for k in range(tns.rc_order[f]):
                    self._ac_encode(
                        int(T.AC_TNS_COEF_CUMFREQ[k][tns.rc_i[k + 8 * f]]),
                        int(T.AC_TNS_COEF_FREQ[k][tns.rc_i[k + 8 * f]]),
                    )

    def _spectral_data(self, spec, x_q) -> None:
        self.nbits_side_initial = self.w.nbits_side_written(self.nbits)
        self.lsbs = [0] * spec.nbits_lsb
        nlsbs = 0
        lookup = T.AC_SPEC_LOOKUP
        cumfreq = T.AC_SPEC_CUMFREQ
        freq = T.AC_SPEC_FREQ
        lsb_mode = spec.lsb_mode
        c = 0
        for k in range(0, spec.lastnz_trunc, 2):
            t = c + spec.rate_flag + (256 if k > self.ne // 2 else 0)
            a = abs(int(x_q[k]))
            a_lsb = a
            b = abs(int(x_q[k + 1]))
            b_lsb = b
            lev = 0
            lsb0 = 0
            lsb1 = 0
            while max(a, b) >= 4:
                pki = int(lookup[t + min(lev, 3) * 1024])
                self._ac_encode(int(cumfreq[pki][16]), int(freq[pki][16]))
                if lsb_mode and lev == 0:
                    lsb0 = a & 1
                    lsb1 = b & 1
                else:
                    self.w.write_bool_backward((a & 1) == 1)
                    self.w.write_bool_backward((b & 1) == 1)
                a >>= 1
                b >>= 1
                lev += 1
            pki = int(lookup[t + min(lev, 3) * 1024])
            sym = a + 4 * b
            self._ac_encode(int(cumfreq[pki][sym]), int(freq[pki][sym]))

            if lsb_mode and lev > 0:
                a_lsb >>= 1
                b_lsb >>= 1
                self.lsbs[nlsbs] = lsb0
                nlsbs += 1
                if a_lsb == 0 and x_q[k] != 0:
                    self.lsbs[nlsbs] = 0 if x_q[k] > 0 else 1
                    nlsbs += 1
                self.lsbs[nlsbs] = lsb1
                nlsbs += 1
                if b_lsb == 0 and x_q[k + 1] != 0:
                    self.lsbs[nlsbs] = 0 if x_q[k + 1] > 0 else 1
                    nlsbs += 1
            if a_lsb > 0:
                self.w.write_bool_backward(x_q[k] <= 0)
            if b_lsb > 0:
                self.w.write_bool_backward(x_q[k + 1] <= 0)
            lev = min(lev, 3)
            t = 1 + (a + b) * (lev + 1) if lev <= 1 else 12 + lev
            c = (c & 15) * 16 + t
        self.nlsbs = nlsbs

    def _residual_and_finish(self, lsb_mode: bool, residual_bits: list) -> None:
        nbits_side = self.w.nbits_side_written(self.nbits)
        nbits_ari = self._nbits_ari_forecast()
        nbits_residual_enc = max(0, self.nbits - (nbits_side + nbits_ari))

        if not lsb_mode:
            for bit in residual_bits[:nbits_residual_enc]:
                self.w.write_bool_backward(bit)
        else:
            for k in range(min(nbits_residual_enc, self.nlsbs)):
                self.w.write_bool_backward(self.lsbs[k] == 1)

        self._ac_finish()
