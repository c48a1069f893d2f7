"""Decoder long-term post filter (reference decoder/long_term_post_filter.rs).

An IIR pitch post-filter over the reconstructed time signal with five
transition behaviours per frame (inactive, fade-in, fade-out, steady,
pitch-change = fade-out then fade-in), operating on 2 (10 ms) or 3 (7.5 ms)
frame circular buffers of filter input and output.
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .config import FrameDuration, Lc3Config
from .side_info import LtpfInfo

F32 = np.float32


def _l_den(fs: int) -> int:
    return {8000: 4, 16000: 4, 24000: 6, 32000: 8, 44100: 11, 48000: 12}[fs]


def compute_gains(cfg: Lc3Config, nbits: int) -> tuple[np.float32, int]:
    """(gain_ltpf, gain_ind) from the frame bit budget."""
    if cfg.n_ms == FrameDuration.MS7P5:
        # f64 round() = half away from zero (Rust semantics)
        t_nbits = int(np.floor(nbits * 10.0 / 7.5 + 0.5))
    else:
        t_nbits = nbits
    base = cfg.fs_ind * 80
    if t_nbits < 320 + base:
        return F32(0.4), 0
    if t_nbits < 400 + base:
        return F32(0.35), 1
    if t_nbits < 480 + base:
        return F32(0.3), 2
    if t_nbits < 560 + base:
        return F32(0.25), 3
    return F32(0.0), 0


def compute_filter_parameters(cfg: Lc3Config, info: LtpfInfo) -> tuple[int, int]:
    """pitch_index -> (p_int, p_fr) at the output sampling rate."""
    if not info.is_active:
        return 0, 0
    pi = info.pitch_index
    if pi >= 440:
        pitch_int, pitch_fr = pi - 283, 0.0
    elif pi >= 380:
        pitch_int = pi // 2 - 63
        pitch_fr = float(2 * pi - 4 * pitch_int - 252)
    else:
        pitch_int = pi // 4 + 32
        pitch_fr = float(pi + 128 - 4 * pitch_int)
    pitch = pitch_int + pitch_fr / 4.0
    pitch_fs = pitch * (8000.0 * np.ceil(cfg.fs / 8000.0) / 12800.0)
    p_up = int(pitch_fs * 4.0 + 0.5)
    return p_up // 4, p_up - 4 * (p_up // 4)


class LongTermPostFilter:
    def __init__(self, cfg: Lc3Config):
        self.cfg = cfg
        l_den = _l_den(cfg.fs)
        l_num = l_den - 2
        if cfg.n_ms == FrameDuration.MS10:
            self.num_mem_blocks, self.norm = 2, cfg.nf // 4
        else:
            self.num_mem_blocks, self.norm = 3, cfg.nf // 3
        self.c_num = np.zeros(l_num + 1, dtype=F32)
        self.c_den = np.zeros(l_den + 1, dtype=F32)
        self.c_num_mem = np.zeros(l_num + 1, dtype=F32)
        self.c_den_mem = np.zeros(l_den + 1, dtype=F32)
        total = self.num_mem_blocks * cfg.nf
        self.x_hat_mem = np.zeros(total, dtype=F32)
        self.x_hat_ltpf_mem = np.zeros(total, dtype=F32)
        self.p_int_mem = 0
        self.p_fr_mem = 0
        self.active_prev = False
        self.blk = 0

    def _compute_coeffs(self, info: LtpfInfo, nbits: int, pitch_frac: int) -> None:
        self.c_num_mem[:] = self.c_num
        self.c_den_mem[:] = self.c_den
        if not info.is_active:
            self.c_num[:] = 0.0
            self.c_den[:] = 0.0
            return
        gain_ltpf, gain_ind = compute_gains(self.cfg, nbits)
        tab_num = T.ltpf_num_table(self.cfg.fs)[gain_ind]
        tab_den = T.ltpf_den_table(self.cfg.fs)[pitch_frac]
        n = min(len(self.c_num), len(tab_num))
        self.c_num[:n] = (F32(0.85) * gain_ltpf) * tab_num[:n]
        n = min(len(self.c_den), len(tab_den))
        self.c_den[:n] = gain_ltpf * tab_den[:n]

    def _wrap(self, index: int) -> int:
        if index < 0:
            return index + self.num_mem_blocks * self.cfg.nf
        return index

    def _filter_at(self, start: int, pitch_int: int, c_num, c_den) -> np.float32:
        l_den = len(c_den) - 1
        out = F32(0.0)
        for k in range(len(c_num)):
            out += c_num[k] * self.x_hat_mem[self._wrap(start - k)]
        start_den = start - pitch_int + l_den // 2
        for k in range(len(c_den)):
            out -= c_den[k] * self.x_hat_ltpf_mem[self._wrap(start_den - k)]
        return out

    def run(self, info: LtpfInfo, nbits: int, x: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        nf = cfg.nf
        pitch_int, pitch_frac = compute_filter_parameters(cfg, info)
        self._compute_coeffs(info, nbits, pitch_frac)

        blk = self.blk
        self.x_hat_mem[blk : blk + nf] = x
        s2p5 = (48000 if cfg.fs == 44100 else cfg.fs) // 400
        norm = F32(self.norm)
        xin, xout = self.x_hat_mem, self.x_hat_ltpf_mem

        if not info.is_active and not self.active_prev:
            xout[blk : blk + nf] = xin[blk : blk + nf]
        elif info.is_active and not self.active_prev:
            for n in range(s2p5):
                xout[blk + n] = xin[blk + n]
                f = self._filter_at(blk + n, pitch_int, self.c_num, self.c_den)
                f = f * (F32(n) / norm)
                xout[blk + n] -= f
            for n in range(s2p5, nf):
                xout[blk + n] = xin[blk + n]
                xout[blk + n] -= self._filter_at(blk + n, pitch_int, self.c_num, self.c_den)
        elif not info.is_active and self.active_prev:
            self._fade_out(s2p5, blk)
            xout[blk + s2p5 : blk + nf] = xin[blk + s2p5 : blk + nf]
        elif pitch_int == self.p_int_mem and pitch_frac == self.p_fr_mem:
            for n in range(nf):
                xout[blk + n] = xin[blk + n]
                xout[blk + n] -= self._filter_at(blk + n, pitch_int, self.c_num, self.c_den)
        else:
            self._fade_out(s2p5, blk)
            self._fade_in_from_mem(blk, pitch_int, s2p5)
            for n in range(s2p5, nf):
                xout[blk + n] = xin[blk + n]
                xout[blk + n] -= self._filter_at(blk + n, pitch_int, self.c_num, self.c_den)

        out = xout[blk : blk + nf].copy()
        self.blk += nf
        if self.blk > (self.num_mem_blocks - 1) * nf:
            self.blk = 0
        self.active_prev = info.is_active
        self.p_int_mem = pitch_int
        self.p_fr_mem = pitch_frac
        return out

    def _fade_out(self, s2p5: int, blk: int) -> None:
        norm = F32(self.norm)
        for n in range(s2p5):
            self.x_hat_ltpf_mem[blk + n] = self.x_hat_mem[blk + n]
            f = self._filter_at(blk + n, self.p_int_mem, self.c_num_mem, self.c_den_mem)
            f = f * (F32(1.0) - F32(n) / norm)
            self.x_hat_ltpf_mem[blk + n] -= f

    def _fade_in_from_mem(self, blk: int, pitch_int: int, s2p5: int) -> None:
        cfg = self.cfg
        l_num = len(self.c_num) - 1
        l_den = len(self.c_den) - 1
        norm = F32(self.norm)
        # snapshot of already-filtered output [-l_num, norm) for the numerator
        scratch = np.empty(l_num + self.norm, dtype=F32)
        if blk < l_num:
            frm = self.num_mem_blocks * cfg.nf - l_num
            scratch[:l_num] = self.x_hat_ltpf_mem[frm : frm + l_num]
            scratch[l_num:] = self.x_hat_ltpf_mem[: self.norm]
        else:
            scratch[:] = self.x_hat_ltpf_mem[blk - l_num : blk + self.norm]

        for n in range(s2p5):
            self.x_hat_ltpf_mem[blk + n] = scratch[n + l_num]
            f = F32(0.0)
            for k in range(len(self.c_num)):
                f += self.c_num[k] * scratch[l_num + n - k]
            start_den = blk + n - pitch_int + l_den // 2
            for k in range(len(self.c_den)):
                f -= self.c_den[k] * self.x_hat_ltpf_mem[self._wrap(start_den - k)]
            f = f * (F32(n) / norm)
            self.x_hat_ltpf_mem[blk + n] -= f
