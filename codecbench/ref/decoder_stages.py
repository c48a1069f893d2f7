"""Decoder spectral-domain stages (reference-exact float32).

Covers: residual refinement (decoder/residual_spectrum.rs), noise filling
(decoder/noise_filling.rs), global gain (decoder/global_gain.rs), TNS
synthesis lattice (decoder/temporal_noise_shaping.rs), SNS synthesis incl.
MPVQ de-enumeration (decoder/spectral_noise_shaping.rs), and packet-loss
concealment (decoder/packet_loss_concealment.rs).
"""

from __future__ import annotations

import math

import numpy as np

from . import tables as T
from .config import FrameDuration, Lc3Config
from . import fp
from .side_info import SnsVq

F32 = np.float32

BW_STOP_7P5MS = [60, 120, 180, 240, 300]
BW_STOP_10MS = [80, 160, 240, 320, 400]


def residual_decode(lsb_mode: bool, residual_bits: list, x: np.ndarray) -> None:
    """Apply residual refinement bits in place (+-0.3125 / -+0.1875)."""
    if lsb_mode:
        return
    it = iter(residual_bits)
    for k in range(len(x)):
        if x[k] != 0.0:
            bit = next(it, None)
            if bit is None:
                break
            if bit:
                x[k] += F32(0.3125) if x[k] > 0.0 else F32(0.1875)
            else:
                x[k] -= F32(0.1875) if x[k] > 0.0 else F32(0.3125)


def noise_filling(
    is_zero_frame: bool,
    seed: int,
    bandwidth: int,
    n_ms: FrameDuration,
    noise_factor: int,
    x_int: list,
    x: np.ndarray,
) -> None:
    """LCG noise fill of all-zero neighbourhoods in [nf_start, bw_stop)."""
    if is_zero_frame:
        return
    if n_ms == FrameDuration.MS7P5:
        bw_stop, nf_start, nf_width = BW_STOP_7P5MS[bandwidth], 18, 2
    else:
        bw_stop, nf_start, nf_width = BW_STOP_10MS[bandwidth], 24, 3
    noise_level = F32(F32(8.0) - F32(noise_factor)) / F32(16.0)
    for k in range(nf_start, min(bw_stop, len(x))):
        lo = k - nf_width
        hi = min(bw_stop - 1, k + nf_width)
        if all(v == 0 for v in x_int[lo : hi + 1]):
            seed = (13849 + seed * 31821) & 0xFFFF
            x[k] = noise_level if seed < 0x8000 else -noise_level


def global_gain(frame_num_bits: int, fs_ind: int, gg_ind: int, x: np.ndarray) -> None:
    fs = fs_ind + 1
    gg_off = -min(frame_num_bits // (10 * fs), 115) - 105 - 5 * fs
    exponent = F32(F32(gg_ind) + F32(gg_off)) / F32(28.0)
    gg = fp.powf(F32(10.0), exponent)
    x *= gg


def _tns_band_ranges(n_ms: FrameDuration, bandwidth: int) -> list:
    if n_ms == FrameDuration.MS10:
        return [
            [(12, 80)],
            [(12, 160)],
            [(12, 240)],
            [(12, 160), (160, 320)],
            [(12, 200), (200, 400)],
        ][bandwidth]
    return [
        [(9, 60)],
        [(9, 120)],
        [(9, 180)],
        [(9, 120), (120, 240)],
        [(9, 150), (150, 300)],
    ][bandwidth]


def tns_synthesis(
    n_ms: FrameDuration,
    bandwidth: int,
    num_tns_filters: int,
    rc_order: list,
    rc_i: list,
    x: np.ndarray,
) -> None:
    """Inverse TNS: per-band IIR lattice with 8-deep shared state."""
    bands = _tns_band_ranges(n_ms, bandwidth)
    step = F32(math.pi / 17.0)
    rc_q = [F32(0.0)] * (T.TNS_NUMFILTERS_MAX * T.MAXLAG)
    for i, rci in enumerate(rc_i[: len(rc_q)]):
        if rci != 0:
            rc_q[i] = fp.sinf(step * F32(rci - 8))

    state = [F32(0.0)] * 8
    for f in range(min(num_tns_filters, len(bands))):
        order = rc_order[f]
        if order <= 0:
            continue
        off = f * 8
        lo, hi = bands[f]
        for n in range(lo, hi):
            k = order - 1
            t = x[n] - rc_q[k + off] * state[k]
            for k in range(order - 2, -1, -1):
                rc = rc_q[k + off]
                t -= rc * state[k]
                state[k + 1] = rc * t + state[k]
            x[n] = t
            state[0] = t


def mpvq_deenum(dim: int, k_val: int, ls_ind: int, mpvq_ind: int) -> list:
    """MPVQ index -> pulse vector (decoder/spectral_noise_shaping.rs:155-199)."""
    vec = [0] * dim
    leading_sign = 1 if ls_ind == 0 else -1
    k_max = k_val
    ind = mpvq_ind
    for pos in range(dim):
        row = T.MPVQ_OFFSETS[dim - 1 - pos]
        if ind == 0:
            vec[pos] = k_max * leading_sign
            break
        k_acc = k_max
        while ind < int(row[k_acc]):
            k_acc -= 1
        ind = ind - int(row[k_acc])
        k_delta = k_max - k_acc
        if k_delta != 0:
            vec[pos] = k_delta * leading_sign
            leading_sign = -1 if (ind & 1) else 1
            ind >>= 1
            k_max -= k_delta
    return vec


def sns_decode(cfg: Lc3Config, sns: SnsVq, x: np.ndarray) -> None:
    """SNS synthesis: stage-1 + MPVQ stage-2, interpolate, scale spectrum."""
    stage1 = np.concatenate([T.LFCB[sns.ind_lf], T.HFCB[sns.ind_hf]]).astype(F32)

    shape_j = (sns.submode_msb << 1) + sns.submode_lsb
    if shape_j == 0:
        y = mpvq_deenum(10, 10, sns.ls_inda, sns.idx_a) + [0] * 6
        z = mpvq_deenum(6, 1, sns.ls_indb, sns.idx_b)
        y[10:16] = z[:6]
    elif shape_j == 1:
        y = mpvq_deenum(10, 10, sns.ls_inda, sns.idx_a) + [0] * 6
    elif shape_j == 2:
        y = mpvq_deenum(16, 8, sns.ls_inda, sns.idx_a)
    else:
        y = mpvq_deenum(16, 6, sns.ls_inda, sns.idx_a)

    y_norm = F32(0.0)
    for v in y:
        y_norm += F32(v) * F32(v)
    y_norm = np.sqrt(y_norm)

    gain = F32(T.SNS_GAINS_BY_SHAPE[shape_j][sns.g_ind])
    if y_norm != 0.0:
        gain = gain / y_norm

    # synthesis through the DCT-16 rotation, sequential accumulation order
    scf_q = np.empty(16, dtype=F32)
    d = T.DCT16
    for n in range(16):
        factor = F32(0.0)
        for col in range(16):
            factor += F32(y[col]) * d[n, col]
        scf_q[n] = stage1[n] + gain * factor

    # 16 -> 64 interpolation
    interp = np.empty(64, dtype=F32)
    interp[0] = scf_q[0]
    interp[1] = scf_q[0]
    for n in range(15):
        diff = scf_q[n + 1] - scf_q[n]
        interp[4 * n + 2] = scf_q[n] + F32(1.0 / 8.0) * diff
        interp[4 * n + 3] = scf_q[n] + F32(3.0 / 8.0) * diff
        interp[4 * n + 4] = scf_q[n] + F32(5.0 / 8.0) * diff
        interp[4 * n + 5] = scf_q[n] + F32(7.0 / 8.0) * diff
    interp[62] = scf_q[15] + F32(1.0 / 8.0) * (scf_q[15] - scf_q[14])
    interp[63] = scf_q[15] + F32(3.0 / 8.0) * (scf_q[15] - scf_q[14])

    nb = cfg.nb
    n2 = 64 - nb
    if n2 != 0:
        for i in range(n2):
            interp[i] = (interp[2 * i] + interp[2 * i + 1]) / F32(2.0)
        for i in range(n2, nb):
            interp[i] = interp[i + n2]

    g_sns = np.array([fp.exp2_raw(interp[b]) for b in range(nb)], dtype=F32)

    i_fs = T.band_indices(cfg)
    for b in range(nb):
        x[i_fs[b] : i_fs[b + 1]] *= g_sns[b]


class PacketLossConcealment:
    """Replay of the last good spectrum with random signs + attenuation."""

    def __init__(self, ne: int):
        self.ne = ne
        self.last_good = np.zeros(ne, dtype=F32)
        self.num_lost_frames = 0
        self.alpha = F32(1.0)
        self.plc_seed = 24607

    def save(self, x: np.ndarray) -> None:
        self.num_lost_frames = 0
        self.alpha = F32(1.0)
        self.last_good[:] = x[: self.ne]

    def load_into(self, x: np.ndarray) -> None:
        if self.num_lost_frames >= 4:
            self.alpha = self.alpha * (F32(0.9) if self.num_lost_frames < 8 else F32(0.85))
        self.num_lost_frames += 1
        for k in range(self.ne):
            self.plc_seed = (16831 + self.plc_seed * 12821) & 0xFFFF
            sign_alpha = self.alpha if self.plc_seed < 0x8000 else -self.alpha
            x[k] = self.last_good[k] * sign_alpha


def output_scaling(x: np.ndarray) -> np.ndarray:
    """Round half away from zero and clip to i16 (decoder/output_scaling.rs)."""
    shifted = np.where(x > 0.0, x + F32(0.5), x - F32(0.5))
    ints = shifted.astype(np.int32)
    return np.clip(ints, -32768, 32767).astype(np.int16)
