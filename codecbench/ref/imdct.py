"""Inverse low-delay MDCT + overlap-add (reference decoder/modified_dct.rs).

Spectral lines (ne) are zero-padded to nf, passed through a DCT-IV, mirrored
into a 2*nf time-alias buffer with a half-frame rotation and sign flips,
windowed with the reversed spec window, and overlap-added against the
previous frame's tail.
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .config import Lc3Config
from .fft import FaithfulDctIV

F32 = np.float32


class InverseMdct:
    def __init__(self, cfg: Lc3Config):
        self.cfg = cfg
        self.dct = FaithfulDctIV(cfg.nf)
        self.wn_rev = T.mdct_window(cfg)[::-1].copy()
        self.mem_ola_add = np.zeros(cfg.nf - cfg.z, dtype=F32)
        self.gain = F32(1.0) / np.sqrt(F32(2.0) * F32(cfg.nf))

    def run(self, spec_lines: np.ndarray) -> np.ndarray:
        nf, z, ne = self.cfg.nf, self.cfg.z, self.cfg.ne
        buf = np.zeros(nf, dtype=F32)
        buf[:ne] = spec_lines[:ne]
        buf = self.dct(buf)

        # time-alias buffer: [buf, -reverse(buf)] rotated left by nf/2 with a
        # sign flip on the wrapped half (modified_dct.rs:97-130)
        half = nf // 2
        t_hat = np.empty(2 * nf, dtype=F32)
        t_hat[: nf - half] = buf[half:]
        t_hat[nf - half : nf] = -buf[::-1][: half]
        t_hat[nf : 2 * nf - half] = -buf[::-1][half:]
        t_hat[2 * nf - half :] = -buf[:half]

        t_hat *= self.gain
        t_hat *= self.wn_rev

        out = np.empty(nf, dtype=F32)
        out[: nf - z] = self.mem_ola_add + t_hat[z:nf]
        out[nf - z :] = t_hat[nf : nf + z]
        self.mem_ola_add[:] = t_hat[nf + z : 2 * nf]
        return out
