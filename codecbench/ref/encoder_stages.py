"""Encoder side stages: bandwidth detector, attack detector, noise level,
residual bits (reference encoder/{bandwidth_detector,attack_detector,
noise_level_estimation,residual_spectrum}.rs).
"""

from __future__ import annotations

import numpy as np

from .config import FrameDuration, Lc3Config
from .fp import seq_sum

F32 = np.float32

I_BW_START_10MS = [[53, 0, 0, 0], [47, 59, 0, 0], [44, 54, 60, 0], [41, 51, 57, 61]]
I_BW_STOP_10MS = [[63, 0, 0, 0], [56, 63, 0, 0], [52, 59, 63, 0], [49, 55, 60, 63]]
I_BW_START_7P5MS = [[51, 0, 0, 0], [45, 58, 0, 0], [42, 53, 60, 0], [40, 51, 57, 61]]
I_BW_STOP_7P5MS = [[63, 0, 0, 0], [55, 63, 0, 0], [51, 58, 63, 0], [48, 55, 60, 63]]
NBITS_BW_TABLE = [0, 1, 2, 2, 3]
QUIETNESS_THRESH = [20, 10, 10, 10]
CUTOFF_THRESH = [15, 23, 20, 20]
L_10MS = [4, 4, 3, 1]
L_7P5MS = [4, 4, 3, 2]


class BandwidthDetector:
    def __init__(self, cfg: Lc3Config):
        self.fs_ind = cfg.fs_ind
        if cfg.fs_ind > 0:
            if cfg.n_ms == FrameDuration.MS10:
                self.start = I_BW_START_10MS[cfg.fs_ind - 1]
                self.stop = I_BW_STOP_10MS[cfg.fs_ind - 1]
                self.l = L_10MS
            else:
                self.start = I_BW_START_7P5MS[cfg.fs_ind - 1]
                self.stop = I_BW_STOP_7P5MS[cfg.fs_ind - 1]
                self.l = L_7P5MS

    def run(self, e_b: np.ndarray) -> tuple[int, int]:
        """Returns (bandwidth_ind, nbits_bandwidth)."""
        nbits = NBITS_BW_TABLE[self.fs_ind]
        if self.fs_ind == 0:
            return 0, nbits

        bw_ind = 0
        for k in range(self.fs_ind - 1, -1, -1):
            start, stop = self.start[k], self.stop[k]
            width = F32(stop + 1 - start)
            quietness = seq_sum(e_b[start : stop + 1].astype(F32) / width)
            if quietness >= F32(QUIETNESS_THRESH[k]):
                bw_ind = k + 1
                break

        if self.fs_ind == bw_ind:
            return bw_ind, nbits

        l_bw = self.l[bw_ind]
        frm = self.start[bw_ind] + 1 - l_bw
        to = self.start[bw_ind]
        cutoff_max = F32(0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            for n in range(frm, to):
                # 0/0 -> nan on silence; the > comparison below is then false,
                # matching the reference's IEEE semantics
                cutoff = F32(e_b[n - l_bw]) / F32(e_b[n])
                cutoff_max = max(cutoff, cutoff_max)
        if cutoff_max > F32(CUTOFF_THRESH[bw_ind]):
            return bw_ind, nbits
        return self.fs_ind, nbits


class AttackDetector:
    def __init__(self, cfg: Lc3Config):
        self.cfg = cfg
        if cfg.n_ms == FrameDuration.MS10:
            self.num_downsampled, self.num_blocks, self.attack_pos_limit = 160, 4, 2
        else:
            self.num_downsampled, self.num_blocks, self.attack_pos_limit = 120, 3, 1
        self.energy_last = F32(0.0)
        self.max_energy_last = F32(0.0)
        self.attack_pos_last = -1
        self.downsampled_tminus1 = 0
        self.downsampled_tminus2 = 0

    def _is_active(self, nbytes: int) -> bool:
        fs = self.cfg.fs
        if fs < 32000:
            return False
        if self.cfg.n_ms == FrameDuration.MS7P5:
            return (fs == 32000 and 61 <= nbytes < 150) or (fs >= 44100 and 75 <= nbytes < 150)
        return (fs == 32000 and nbytes > 80) or (fs >= 41000 and nbytes >= 100)

    def run(self, x_s: np.ndarray, nbytes: int) -> bool:
        if not self._is_active(nbytes):
            self.energy_last = F32(0.0)
            self.max_energy_last = F32(0.0)
            self.attack_pos_last = -1
            return False

        block_len = self.cfg.nf // self.num_downsampled
        ds = x_s.astype(np.int64).reshape(self.num_downsampled, block_len).sum(axis=1)

        hp = np.empty(self.num_downsampled, dtype=F32)
        prev = np.empty(self.num_downsampled, dtype=F32)
        prev2 = np.empty(self.num_downsampled, dtype=F32)
        dsf = ds.astype(F32)
        prev[0] = F32(self.downsampled_tminus1)
        prev2[0] = F32(self.downsampled_tminus2)
        prev[1:] = dsf[:-1]
        prev2[1] = F32(self.downsampled_tminus1)
        prev2[2:] = dsf[:-2]
        hp = F32(0.375) * dsf - F32(0.5) * prev + F32(0.125) * prev2

        self.downsampled_tminus1 = int(ds[-1])
        self.downsampled_tminus2 = int(ds[-2])

        attack_position = -1
        for n in range(self.num_blocks):
            energy = seq_sum(hp[40 * n : 40 * n + 40] * hp[40 * n : 40 * n + 40])
            max_energy = max(F32(0.25) * self.max_energy_last, self.energy_last)
            if energy > F32(8.5) * max_energy:
                attack_position = n
            self.energy_last = energy
            self.max_energy_last = max_energy

        detected = attack_position >= 0 or self.attack_pos_last >= self.attack_pos_limit
        self.attack_pos_last = attack_position
        return detected


def noise_level_estimation(
    cfg: Lc3Config, x_f: np.ndarray, x_q: np.ndarray, bandwidth_ind: int, gg: np.float32
) -> int:
    if cfg.n_ms == FrameDuration.MS10:
        bw_stop = [80, 160, 240, 320, 400][bandwidth_ind]
        nf_start, nf_width = 24, 3
    else:
        bw_stop = [60, 120, 180, 240, 300][bandwidth_ind]
        nf_start, nf_width = 18, 2

    total = F32(0.0)
    count = 0
    nf_stop = min(cfg.ne, bw_stop)
    for k in range(nf_start, nf_stop):
        lo = k - nf_width
        hi = min(bw_stop, k + nf_width + 1)
        if np.all(x_q[lo:hi] == 0):
            total = total + np.abs(F32(x_f[k])) / gg
            count += 1

    noise_level = total / F32(count) if count > 0 else F32(0.0)
    diff = F32(8.0) - F32(16.0) * noise_level
    if diff >= 0.0:
        return min(7, int(diff + F32(0.5)))
    return 0


def residual_bits_encode(
    nbits_spec: int, nbits_trunc: int, ne: int, gg: np.float32, x_f: np.ndarray, x_q: np.ndarray
) -> list:
    nbits_residual_max = max(0, nbits_spec - nbits_trunc + 4)
    bits = []
    if nbits_residual_max > 0:
        for k in range(ne):
            if len(bits) >= nbits_residual_max:
                break
            if x_q[k] != 0:
                bits.append(bool(F32(x_f[k]) >= F32(x_q[k]) * gg))
    return bits
