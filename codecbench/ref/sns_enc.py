"""SNS analysis + two-stage vector quantization (reference
encoder/spectral_noise_shaping.rs).

Pipeline: pad bands to 64 -> 3-tap smoothing -> pre-emphasis -> noise floor
-> half-log2 -> 64->16 grouping -> mean removal -> attack smoothing -> stage1
(32-entry LF/HF codebook MSE search) -> stage2 (DCT-16 rotation, greedy PVQ
pyramid projection for shapes 3/2/1/0, sign assignment, unit-energy
normalisation, shape+gain MSE selection, MPVQ enumeration) -> scale factor
synthesis, interpolation 16->64 and per-band spectral shaping.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as T
from .config import FrameDuration, Lc3Config
from . import fp
from .fp import seq_sum

F32 = np.float32

G_TILT = [14, 18, 22, 26, 30]
WEIGHTING = np.array(
    [1.0 / 12.0, 2.0 / 12.0, 3.0 / 12.0, 3.0 / 12.0, 2.0 / 12.0, 1.0 / 12.0], dtype=F32
)
NBITS_SNS = 38


@dataclass
class SnsResult:
    ind_lf: int
    ind_hf: int
    shape_j: int
    gind: int
    ls_inda: int
    ls_indb: int
    index_joint_j: int


class SpectralNoiseShapingEncoder:
    def __init__(self, cfg: Lc3Config):
        self.cfg = cfg
        self.g_tilt = G_TILT[cfg.fs_ind]
        self.band_idx = T.band_indices(cfg)
        # pre-emphasis gains 10^(b * g_tilt / 630), computed with f32 powf
        exponent = F32(self.g_tilt) / F32(630.0)
        self.preemph = np.array(
            [fp.powf(F32(10.0), F32(b) * exponent) for b in range(64)], dtype=F32
        )

    def run(self, x: np.ndarray, e_b: np.ndarray, attack_detected: bool) -> SnsResult:
        cfg = self.cfg
        nb = cfg.nb

        # padding 60 -> 64 for NB 7.5 ms
        diff = 64 - nb
        padded = np.empty(64, dtype=F32)
        if diff > 0:
            padded[: 2 * diff : 2] = e_b[:diff]
            padded[1 : 2 * diff : 2] = e_b[:diff]
            padded[2 * diff :] = e_b[diff:]
        else:
            padded[:] = e_b

        # 3-tap smoothing
        sm = np.empty(64, dtype=F32)
        sm[0] = F32(0.75) * padded[0] + F32(0.25) * padded[1]
        sm[1:-1] = (
            F32(0.25) * padded[:-2] + F32(0.5) * padded[1:-1] + F32(0.25) * padded[2:]
        )
        sm[-1] = F32(0.25) * padded[-2] + F32(0.75) * padded[-1]

        # pre-emphasis
        sm *= self.preemph

        # noise floor: max(total/64 * 1e-4, 2^-32)
        total = seq_sum(sm)
        total = (total / F32(64.0)) * F32(1e-4)
        noise_floor = max(F32(2.0**-32), total)
        sm = np.maximum(sm, noise_floor)

        # half log2
        eps = F32(np.finfo(np.float32).eps)
        sm = np.array([fp.log2f(eps + v) for v in sm], dtype=F32) / F32(2.0)

        # 64 -> 16 grouping with 6-tap weights
        ds = np.empty(16, dtype=F32)
        acc = WEIGHTING[0] * sm[0]
        for k in range(1, 6):
            acc = acc + WEIGHTING[k] * sm[k - 1]
        ds[0] = acc
        for b2 in range(1, 15):
            frm = 4 * b2 - 1
            acc = F32(0.0)
            for k in range(6):
                acc = acc + WEIGHTING[k] * sm[frm + k]
            ds[b2] = acc
        acc = WEIGHTING[5] * sm[63]
        for k in range(5):
            acc = acc + WEIGHTING[k] * sm[60 + k - 1]
        ds[15] = acc

        # mean removal and scaling
        avg = seq_sum(ds) / F32(16.0)
        ds = F32(0.85) * (ds - avg)

        # attack handling
        scf = np.empty(16, dtype=F32)
        if attack_detected:
            scf[0] = seq_sum(ds[0:3]) / F32(3.0)
            scf[1] = seq_sum(ds[0:4]) / F32(4.0)
            for n in range(2, 14):
                scf[n] = seq_sum(ds[n - 2 : n + 3]) / F32(5.0)
            scf[14] = seq_sum(ds[12:16]) / F32(4.0)
            scf[15] = seq_sum(ds[13:16]) / F32(3.0)
            avg = seq_sum(scf) / F32(16.0)
            atten = F32(0.5) if cfg.n_ms == FrameDuration.MS10 else F32(0.3)
            scf = atten * (scf - avg)
        else:
            scf[:] = ds

        # two-stage VQ
        st1, r1, ind_lf, ind_hf = _stage1(scf)
        stage2, scfq = _stage2(r1, st1)

        # interpolation 16 -> 64
        interp = np.empty(64, dtype=F32)
        interp[0] = scfq[0]
        interp[1] = scfq[0]
        for n in range(15):
            d = scfq[n + 1] - scfq[n]
            interp[4 * n + 2] = scfq[n] + F32(0.125) * d
            interp[4 * n + 3] = scfq[n] + F32(0.375) * d
            interp[4 * n + 4] = scfq[n] + F32(0.625) * d
            interp[4 * n + 5] = scfq[n] + F32(0.875) * d
        interp[62] = scfq[15] + F32(0.125) * (scfq[15] - scfq[14])
        interp[63] = scfq[15] + F32(0.375) * (scfq[15] - scfq[14])

        # NB reduction
        if diff > 0:
            for i in range(diff):
                interp[i] = (interp[2 * i] + interp[2 * i + 1]) / F32(2.0)
            for i in range(diff, nb):
                interp[i] = interp[diff + 1]

        # linear domain: 2^(-scf) via exact libm exp2f (encoder path uses exp2,
        # not the fast approximation; spectral_noise_shaping.rs:256)
        gains = np.array([fp.exp2f(-interp[b]) for b in range(nb)], dtype=F32)

        # spectral shaping
        for b in range(nb):
            x[self.band_idx[b] : self.band_idx[b + 1]] *= gains[b]

        return SnsResult(
            ind_lf=ind_lf,
            ind_hf=ind_hf,
            shape_j=stage2["shape_j"],
            gind=stage2["gind"],
            ls_inda=stage2["ls_inda"],
            ls_indb=stage2["ls_indb"],
            index_joint_j=stage2["index_joint_j"],
        )


def _stage1(scf: np.ndarray):
    dmse_lf = np.empty(32, dtype=F32)
    dmse_hf = np.empty(32, dtype=F32)
    for i in range(32):
        dlf = F32(0.0)
        dhf = F32(0.0)
        for n in range(8):
            e = scf[n] - T.LFCB[i, n]
            dlf = dlf + e * e
            e = scf[8 + n] - T.HFCB[i, n]
            dhf = dhf + e * e
        dmse_lf[i] = dlf
        dmse_hf[i] = dhf
    # strict < keeps the first minimum, same as the reference scan
    ind_lf = int(np.argmin(dmse_lf))
    ind_hf = int(np.argmin(dmse_hf))
    st1 = np.concatenate([T.LFCB[ind_lf], T.HFCB[ind_hf]]).astype(F32)
    r1 = scf - st1
    return st1, r1, ind_lf, ind_hf


def _add_unit_pulse(abs_x, n_max, k, k_max, candidate, corr_io, energy_io):
    """Greedy PVQ pulse addition (spectral_noise_shaping.rs:285-316).

    Faithfully reproduces the reference's &mut threading: the returned
    (corr, energy) are the *last inner-scan assignments*, not the true
    accumulators — the reference drops the accumulators (`corr_xy_last`,
    `energy_y_last`) at function exit, and downstream shape searches consume
    the scan-artifact values. Bit-exactness requires copying this behaviour.
    """
    corr_last = corr_io
    energy_last = energy_io
    for _ in range(k, k_max):
        n_best = 0
        corr_io = corr_last + abs_x[0]
        best_corr_sq = corr_io * corr_io
        best_en = energy_last + F32(2.0) * F32(candidate[0]) + F32(1.0)
        for n_c in range(1, n_max):
            corr_io = corr_last + abs_x[n_c]
            energy_io = energy_last + F32(2.0) * F32(candidate[n_c]) + F32(1.0)
            if (corr_io * corr_io) * best_en > best_corr_sq * energy_io:
                n_best = n_c
                best_corr_sq = corr_io * corr_io
                best_en = energy_io
        corr_last = corr_last + abs_x[n_best]
        energy_last = energy_last + F32(2.0) * F32(candidate[n_best]) + F32(1.0)
        candidate[n_best] += 1
    return corr_io, energy_io


def _normalize_candidate(y, n_max):
    norm = F32(0.0)
    for v in y[:n_max]:
        if v != 0:
            norm = norm + F32(v) * F32(v)
    norm = np.sqrt(norm)
    xq = np.zeros(16, dtype=F32)
    for n in range(n_max):
        xq[n] = F32(y[n])
        if y[n] != 0:
            xq[n] = xq[n] / norm
    return xq


def _mpvq_enum(dim: int, vec) -> tuple[int, int]:
    """PVQ vector -> (index, lead_sign_ind) (spectral_noise_shaping.rs:585-612)."""
    next_sign_ind = -(2**31)
    k_val_acc = 0
    index = 0
    n = 0
    tmp_h_row = int(T.MPVQ_OFFSETS[0][0])
    for pos in range(dim - 1, -1, -1):
        val = int(vec[pos])
        if (next_sign_ind & -(2**31)) == 0 and val != 0:
            index = 2 * index + next_sign_ind
        if val < 0:
            next_sign_ind = 1
        elif val > 0:
            next_sign_ind = 0
        index += tmp_h_row
        k_val_acc += -val if val < 0 else val
        if pos != 0:
            n += 1
        if k_val_acc >= 11:
            tmp_h_row = int(T.MPVQ_OFFSETS[n + 1][k_val_acc % 11])
        else:
            tmp_h_row = int(T.MPVQ_OFFSETS[n][k_val_acc])
    return index, next_sign_ind


def _stage2(r1: np.ndarray, st1: np.ndarray):
    d = T.DCT16
    # forward rotation: t2rot[n] = sum_rows r1[row] * D[row][n], row-major order
    t2rot = np.zeros(16, dtype=F32)
    for row in range(16):
        t2rot += r1[row] * d[row]

    # shape 3: project to K=6 pyramid over N=16
    abs_x = np.empty(16, dtype=F32)
    abs_sum = F32(0.0)
    for n in range(16):
        abs_x[n] = np.abs(t2rot[n])
        abs_sum = abs_sum + abs_x[n]
    proj = (F32(6.0) - F32(1.0)) / abs_sum
    y3 = [0] * 16
    k = 0
    corr_xy = F32(0.0)
    energy_y = F32(0.0)
    for n in range(16):
        y3[n] = int(np.floor(abs_x[n] * proj))
        if y3[n] != 0:
            k += y3[n]
            corr_xy = corr_xy + F32(y3[n]) * abs_x[n]
            energy_y = energy_y + F32(y3[n]) * F32(y3[n])

    corr_xy, energy_y = _add_unit_pulse(abs_x, 16, k, 6, y3, corr_xy, energy_y)

    # shape 2: K=8 over N=16
    y2 = list(y3)
    corr_xy, energy_y = _add_unit_pulse(abs_x, 16, 6, 8, y2, corr_xy, energy_y)

    # shape 1: strip set-B pulses, then K=10 over N=10
    y1 = list(y2[:10]) + [0] * 6
    k = 8
    for n in range(10, 16):
        if y2[n] != 0:
            k -= y2[n]
            corr_xy = corr_xy - F32(y2[n]) * abs_x[n]
            energy_y = energy_y - F32(y2[n]) * F32(y2[n])
    corr_xy, energy_y = _add_unit_pulse(abs_x, 10, k, 10, y1, corr_xy, energy_y)

    # shape 0: y1 plus one pulse in set B (N=6)
    y0 = list(y1[:10]) + [0] * 6
    max_abs = F32(0.0)
    n_best = 0
    for n in range(10, 16):
        y0[n] = 0
        if abs_x[n] > max_abs:
            max_abs = abs_x[n]
            n_best = n
    y0[n_best] = 1

    # sign assignment
    for n in range(10):
        if t2rot[n] < 0.0:
            y0[n] = -y0[n]
            y1[n] = -y1[n]
            y2[n] = -y2[n]
            y3[n] = -y3[n]
    for n in range(10, 16):
        if t2rot[n] < 0.0:
            y0[n] = -y0[n]
            y2[n] = -y2[n]
            y3[n] = -y3[n]

    xq0 = _normalize_candidate(y0, 16)
    xq1 = _normalize_candidate(y1, 10)
    xq2 = _normalize_candidate(y2, 16)
    xq3 = _normalize_candidate(y3, 16)

    # shape + gain selection by MSE against the rotated target
    shape_j = 0
    gind = 0
    g_sel = F32(0.0)
    xq_sel = xq0
    d_mse_min = F32(np.inf)
    shapes = [
        (1, T.SNS_GAINS_BY_SHAPE[0], xq0),
        (3, T.SNS_GAINS_BY_SHAPE[1], xq1),
        (3, T.SNS_GAINS_BY_SHAPE[2], xq2),
        (7, T.SNS_GAINS_BY_SHAPE[3], xq3),
    ]
    for j, (g_maxind, gains, xq) in enumerate(shapes):
        for i in range(g_maxind):
            g = F32(gains[i])
            d_mse = F32(0.0)
            for n in range(16):
                e = t2rot[n] - g * xq[n]
                d_mse = d_mse + e * e
            if d_mse < d_mse_min:
                shape_j = j
                gind = i
                d_mse_min = d_mse
                g_sel = g
                xq_sel = xq

    lsb_gain = gind & 1
    ls_inda = 0
    ls_indb = 0
    if shape_j == 0:
        idxa, ls_inda = _mpvq_enum(10, y0)
        idxb, ls_indb = _mpvq_enum(6, y0[10:])
        index_joint = (2 * idxb + ls_indb + 2) * 2390004 + idxa
    elif shape_j == 1:
        idxa, ls_inda = _mpvq_enum(10, y1)
        index_joint = lsb_gain * 2390004 + idxa
    elif shape_j == 2:
        idxa, ls_inda = _mpvq_enum(16, y2)
        index_joint = idxa
    else:
        idxa, ls_inda = _mpvq_enum(16, y3)
        index_joint = 15158272 + lsb_gain + 2 * idxa

    # synthesis of quantized scale factors
    scfq = np.empty(16, dtype=F32)
    for n in range(16):
        factor = F32(0.0)
        for col in range(16):
            factor = factor + xq_sel[col] * d[n, col]
        scfq[n] = st1[n] + g_sel * factor

    return (
        {
            "shape_j": shape_j,
            "gind": gind,
            "ls_inda": ls_inda,
            "ls_indb": ls_indb,
            "index_joint_j": index_joint,
        },
        scfq,
    )
