"""Encoder LTPF pitch analysis (reference encoder/long_term_post_filter.rs).

Polyphase resample to 12.8 kHz (239-tap filter), 50 Hz biquad high-pass,
2x downsample to 6.4 kHz, weighted autocorrelation lag search (17..114),
pitch refinement at 12.8 kHz with fractional interpolation, and the
normalized-correlation activation hysteresis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as T
from .config import FrameDuration, Lc3Config
from .fp import seq_sum

F32 = np.float32

NMEM_12P8D = 232
K_MIN = 17
K_MAX = 114


@dataclass
class LtpfResult:
    pitch_index: int
    pitch_present: bool
    ltpf_active: bool
    nbits_ltpf: int


class LtpfEncoder:
    def __init__(self, cfg: Lc3Config):
        self.cfg = cfg
        if cfg.n_ms == FrameDuration.MS10:
            self.len12p8, self.len6p4, self.delay = 128, 64, 24
        else:
            self.len12p8, self.len6p4, self.delay = 96, 48, 44
        up = {8000: 24, 16000: 12, 24000: 8, 32000: 6, 44100: 4, 48000: 4}[cfg.fs]
        self.p = up
        self.resamp_factor = F32(0.5) if cfg.fs == 8000 else F32(1.0)
        self.x_s_ext = np.zeros(240 // up + cfg.nf, dtype=np.int16)
        self.x12 = np.zeros(self.len12p8 + self.delay + NMEM_12P8D, dtype=F32)
        self.x64 = np.zeros(64 + K_MAX, dtype=F32)
        self.t_prev = K_MIN
        self.mem_pitch = F32(0.0)
        self.mem_ltpf_active = False
        self.mem_nc = F32(0.0)
        self.mem_mem_nc = F32(0.0)
        self.h50_m1 = F32(0.0)
        self.h50_m2 = F32(0.0)
        # precompute resampler gather indices/taps per output phase
        self._resamp_plan = self._build_resamp_plan()

    def _build_resamp_plan(self):
        p = self.p
        plan = []
        for n in range(self.len12p8):
            idxs, taps = [], []
            for k in range(-120 // p, 120 // p + 1):
                index_x_s = (15 * n) // p + k - 120 // p
                index_h = p * k - ((15 * n) % p)
                if -120 < index_h < 120:
                    idxs.append(240 // p + index_x_s)
                    taps.append(T.TAB_RESAMP_FILTER[119 + index_h])
            plan.append((np.array(idxs), np.array(taps, dtype=F32)))
        return plan

    def run(self, x_s: np.ndarray, near_nyquist: bool, nbits: int) -> LtpfResult:
        cfg = self.cfg
        if cfg.n_ms == FrameDuration.MS7P5:
            t_nbits = int(np.floor(nbits * 10.0 / 7.5 + 0.5))
        else:
            t_nbits = nbits
        gain_ltpf_on = t_nbits < 560 + cfg.fs_ind * 80

        # shift histories
        num = 240 // self.p
        self.x_s_ext[:num] = self.x_s_ext[len(self.x_s_ext) - num :]
        self.x_s_ext[num:] = x_s
        self.x12[: len(self.x12) - self.len12p8] = self.x12[self.len12p8 :]
        self.x64[: len(self.x64) - self.len6p4] = self.x64[self.len6p4 :]

        # polyphase resample to 12.8 kHz
        scale = F32(self.p) * self.resamp_factor
        base = self.delay + NMEM_12P8D
        xe = self.x_s_ext.astype(F32)
        for n, (idxs, taps) in enumerate(self._resamp_plan):
            self.x12[base + n] = seq_sum(xe[idxs] * taps) * scale

        # 50 Hz biquad high-pass
        b0, b1, b2 = F32(0.9827947082978771), F32(-1.965589416595754), F32(0.9827947082978771)
        a1, a2 = F32(-1.9652933726226904), F32(0.9658854605688177)
        for n in range(base, base + self.len12p8):
            h50 = self.x12[n] - a1 * self.h50_m1 - a2 * self.h50_m2
            self.x12[n] = b0 * h50 + b1 * self.h50_m1 + b2 * self.h50_m2
            self.h50_m2 = self.h50_m1
            self.h50_m1 = h50

        t_current, pitch_present = self._pitch_detection()
        pitch_index, pitch_int, pitch_fr = self._pitch_lag(t_current)
        ltpf_active, nc, pitch = self._activation(
            pitch_int, pitch_fr, near_nyquist, gain_ltpf_on
        )
        nbits_ltpf = 11 if pitch_present else 1
        if not pitch_present:
            pitch_index = 0
            nc = F32(0.0)

        self.t_prev = t_current
        self.mem_mem_nc = self.mem_nc
        if pitch_present:
            self.mem_pitch = pitch
            self.mem_ltpf_active = ltpf_active
            self.mem_nc = nc
        else:
            self.mem_pitch = F32(0.0)
            self.mem_ltpf_active = False
            self.mem_nc = F32(0.0)

        return LtpfResult(
            pitch_index=pitch_index,
            pitch_present=pitch_present,
            ltpf_active=ltpf_active,
            nbits_ltpf=nbits_ltpf,
        )

    def _pitch_detection(self) -> tuple[int, bool]:
        # 2x downsample with 5-tap window
        c = np.array(
            [0.1236796411180537, 0.2353512128364889, 0.2819382920909148,
             0.2353512128364889, 0.1236796411180537],
            dtype=F32,
        )
        src = self.x12
        for j in range(self.len6p4):
            s = NMEM_12P8D - 3 + 2 * j
            w = src[s : s + 5]
            self.x64[K_MAX + j] = (
                c[0] * w[0] + c[1] * w[1] + c[2] * w[2] + c[3] * w[3] + c[4] * w[4]
            )

        # autocorrelation over lags 17..114 with linear weighting
        nlags = K_MAX + 1 - K_MIN
        r = np.empty(nlags, dtype=F32)
        rw = np.empty(nlags, dtype=F32)
        cur = self.x64[K_MAX : K_MAX + self.len6p4]
        for k in range(nlags):
            frm = K_MAX - K_MIN - k
            r[k] = seq_sum(cur * self.x64[frm : frm + self.len6p4])
            weight = F32(1.0) - F32(0.5) * F32(k) / F32(K_MAX - K_MIN)
            rw[k] = weight * r[k]

        lag_t1 = _first_argmax(rw) + K_MIN
        k_from = max(K_MIN, self.t_prev - 4) - K_MIN
        k_to = min(K_MAX, self.t_prev + 4) - K_MIN + 1
        lag_t2 = _first_argmax(r[k_from:k_to]) + k_from + K_MIN

        nv0 = self._normvalue(0)
        nv1 = self._normvalue(lag_t1)
        denom1 = np.sqrt(nv0 * nv1)
        with np.errstate(divide="ignore", invalid="ignore"):
            # silence gives 0/0 -> nan; max() then keeps 0.0 as the reference's
            # f32 max does with a NaN operand
            normcorr1 = max(F32(0.0), r[lag_t1 - K_MIN] / denom1)
            if lag_t1 == lag_t2:
                normcorr2 = normcorr1
            else:
                nv2 = self._normvalue(lag_t2)
                denom2 = np.sqrt(nv0 * nv2)
                normcorr2 = max(F32(0.0), r[lag_t2 - K_MIN] / denom2)

        if normcorr2 > F32(0.85) * normcorr1:
            return lag_t2, bool(normcorr2 > F32(0.6))
        return lag_t1, bool(normcorr1 > F32(0.6))

    def _normvalue(self, lag: int) -> np.float32:
        frm = K_MAX - lag
        seg = self.x64[frm : frm + self.len6p4]
        return seq_sum(seg * seg)

    def _pitch_lag(self, t_curr: int) -> tuple[int, int, int]:
        k_min = max(32, 2 * t_curr - 4)
        k_max = min(228, 2 * t_curr + 4)
        nk = k_max + 4 - (k_min - 4) + 1
        r12 = np.empty(nk, dtype=F32)
        max_corr = F32(0.0)
        pitch_int = k_min
        cur = self.x12[NMEM_12P8D : NMEM_12P8D + self.len12p8]
        for k in range(k_min - 4, k_max + 5):
            corr = seq_sum(cur * self.x12[NMEM_12P8D - k : NMEM_12P8D + self.len12p8 - k])
            r12[k - (k_min - 4)] = corr
            if corr > max_corr and k_min <= k <= k_max:
                max_corr = corr
                pitch_int = k

        rel = pitch_int - (k_min - 4)
        pitch_fr = 0
        if pitch_int == 32:
            best = F32(0.0)
            for d2 in range(0, 4):
                v = _interp_r(r12, rel, d2)
                if v > best:
                    best = v
                    pitch_fr = d2
        elif 32 < pitch_int < 127:
            best = F32(0.0)
            for d2 in range(-3, 4):
                v = _interp_r(r12, rel, d2)
                if v > best:
                    best = v
                    pitch_fr = d2
        elif 127 <= pitch_int < 157:
            best = F32(0.0)
            for d2 in range(-2, 3, 2):
                v = _interp_r(r12, rel, d2)
                if v > best:
                    best = v
                    pitch_fr = d2

        if pitch_fr < 0:
            pitch_int -= 1
            pitch_fr += 4

        if pitch_int < 127:
            pitch_index = 4 * pitch_int + pitch_fr - 128
        elif 127 <= pitch_int < 157:
            pitch_index = 2 * pitch_int + pitch_fr // 2 - 126
        else:
            pitch_index = pitch_int + 283
        return pitch_index, pitch_int, pitch_fr

    def _dot(self, n: int, d: int) -> np.float32:
        result = F32(0.0)
        for k in range(-2, 3):
            h = 4 * k - d
            if -8 < h < 8:
                result = result + (
                    self.x12[NMEM_12P8D + n - k] * T.TAB_LTPF_INTERP_X12K8[h + 7]
                )
        return result

    def _activation(self, pitch_int, pitch_fr, near_nyquist, gain_ltpf_on):
        nc_num = F32(0.0)
        no_delay_total = F32(0.0)
        shifted_total = F32(0.0)
        for n in range(self.len12p8):
            no_delay = self._dot(n, 0)
            shifted = self._dot(n - pitch_int, pitch_fr)
            nc_num = nc_num + no_delay * shifted
            no_delay_total = no_delay_total + no_delay * no_delay
            shifted_total = shifted_total + shifted * shifted
        denom = np.sqrt(no_delay_total * shifted_total)
        nc = nc_num / denom if denom > 0.0 else F32(0.0)
        pitch = F32(pitch_int) + F32(pitch_fr) / F32(4.0)

        if gain_ltpf_on and not near_nyquist:
            active = (
                (
                    not self.mem_ltpf_active
                    and (self.cfg.n_ms == FrameDuration.MS10 or self.mem_mem_nc > F32(0.94))
                    and self.mem_nc > F32(0.94)
                    and nc > F32(0.94)
                )
                or (self.mem_ltpf_active and nc > F32(0.9))
                or (
                    self.mem_ltpf_active
                    and np.abs(pitch - self.mem_pitch) < F32(2.0)
                    and (nc - self.mem_nc) > F32(-0.1)
                    and nc > F32(0.84)
                )
            )
        else:
            active = False
        return bool(active), nc, pitch


def _first_argmax(arr) -> int:
    if len(arr) == 0:
        return 0
    best = arr[0]
    idx = 0
    for n in range(len(arr)):
        if arr[n] > best:
            idx = n
            best = arr[n]
    return idx


def _interp_r(r12, rel: int, d: int) -> np.float32:
    out = F32(0.0)
    for m in range(-4, 5):
        n = 4 * m - d
        if -16 < n < 16:
            out = out + r12[rel + m] * T.TAB_LTPF_INTERP_R[n + 15]
    return out
