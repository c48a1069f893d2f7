"""Forward low-delay MDCT + per-band energy (reference encoder/modified_dct.rs).

Keeps a 2*nf time history, folds it against the spec window into nf values,
applies a DCT-IV with gain 1/sqrt(2*nf), then computes per-band energies and
the near-Nyquist flag used to gate TNS/LTPF.
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .config import FrameDuration, Lc3Config
from .fft import FaithfulDctIV
from .fp import seq_sum

F32 = np.float32


class ForwardMdct:
    def __init__(self, cfg: Lc3Config):
        self.cfg = cfg
        self.dct = FaithfulDctIV(cfg.nf)
        self.window = T.mdct_window(cfg)
        self.band_idx = T.band_indices(cfg)
        self.time_buf = np.zeros(2 * cfg.nf, dtype=np.int16)  # t[-nf..nf)
        self.gain = F32(1.0) / np.sqrt(F32(2.0) * F32(cfg.nf))

    def run(self, x_s: np.ndarray) -> tuple[np.ndarray, np.ndarray, bool]:
        """Returns (spectrum[nf], energy_bands[nb], near_nyquist_flag)."""
        cfg = self.cfg
        nf, z = cfg.nf, cfg.z
        assert x_s.shape == (nf,)

        # shift history one frame, insert new samples at offset nf - z;
        # the final z samples of the 2*nf buffer are never written (the
        # window is zero there) and stay 0 (modified_dct.rs:126-138)
        self.time_buf[: nf - z] = self.time_buf[nf : 2 * nf - z]
        self.time_buf[nf - z : 2 * nf - z] = x_s

        # window fold (modified_dct.rs:73-97)
        half = nf // 2
        mid = 3 * half
        t = self.time_buf.astype(F32)
        w = self.window
        out = np.empty(nf, dtype=F32)
        t1 = t[mid - half : mid][::-1]
        w1 = w[mid - half : mid][::-1]
        t2 = t[mid : mid + half]
        w2 = w[mid : mid + half]
        out[:half] = (-(t1 * w1)) - (t2 * w2)
        t1 = t[:half]
        w1 = w[:half]
        t2 = t[half:nf][::-1]
        w2 = w[half:nf][::-1]
        out[half:] = (t1 * w1) - (t2 * w2)

        out = self.dct(out)
        out *= self.gain

        # per-band energy: E_B[b] = sum(x^2 / width) in index order
        nb = cfg.nb
        energy = np.empty(nb, dtype=F32)
        for b in range(nb):
            lo, hi = int(self.band_idx[b]), int(self.band_idx[b + 1])
            width = F32(hi - lo)
            energy[b] = seq_sum((out[lo:hi] * out[lo:hi]) / width)

        near_nyquist = False
        if cfg.fs <= 32000:
            nn_idx = nb - 4 if cfg.n_ms == FrameDuration.MS7P5 else nb - 2
            lower = seq_sum(energy[:nn_idx])
            upper = seq_sum(energy[nn_idx:])
            near_nyquist = bool(upper > F32(30.0) * lower)

        return out, energy, near_nyquist
