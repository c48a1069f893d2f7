"""Static per-config decoder constants (the port's copy of
lc3jax/dsp/params.py).

All trig tables, window folds, band maps and LCG jump tables are numpy
constants made once per Lc3Config; convert.decoder_tables puts them on a
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from .. import tables as T
from ..config import FrameDuration, Lc3Config

F32 = np.float32


def dct_iv_matrix(nf: int) -> np.ndarray:
    """Dense DCT-IV basis matching the reference transform's scaling.

    The reference DCT-IV (common/dct_iv.rs:49-67) computes
    y[k] = 2 * sum_n x[n] * cos(pi/nf * (n + 1/2) * (k + 1/2)).
    The decoder's IMDCT runs it as one dense [nf, nf] product.
    """
    n = np.arange(nf)[:, None].astype(np.float64)
    k = np.arange(nf)[None, :].astype(np.float64)
    return (2.0 * np.cos(np.pi / nf * (n + 0.5) * (k + 0.5))).astype(F32)


def lcg_jump_tables(a: int, c: int, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """Jump tables for seed_{m} = A[m]*seed0 + B[m] (mod 2^16).

    The reference advances its 16-bit LCGs once per processed line
    (noise_filling.rs:51, packet_loss_concealment.rs:70); expressing the
    m-step jump in closed form turns both into fully vectorised gathers.
    """
    A = np.empty(steps + 1, dtype=np.int64)
    B = np.empty(steps + 1, dtype=np.int64)
    A[0], B[0] = 1, 0
    for m in range(1, steps + 1):
        A[m] = (A[m - 1] * a) & 0xFFFF
        B[m] = (B[m - 1] * a + c) & 0xFFFF
    return A, B


@dataclass(frozen=True)
class DecoderParams:
    """Per-config constants for the batched decoder."""

    cfg: Lc3Config
    dct: np.ndarray  # [nf, nf] DCT-IV matrix
    window_rev: np.ndarray  # [2nf] reversed low-delay window
    imdct_gain: np.float32
    band_widths: np.ndarray  # [nb]
    band_of_line: np.ndarray  # [ne] band index per spectral line
    nf_lcg_A: np.ndarray  # noise-fill LCG jump tables
    nf_lcg_B: np.ndarray
    plc_lcg_A: np.ndarray
    plc_lcg_B: np.ndarray
    bw_stop: np.ndarray  # [5]
    nf_start: int
    nf_width: int
    tns_max_len: int  # longest TNS-filtered span
    tns_filter_bounds: np.ndarray  # [5, 2, 2] (start, stop) per bw/filter
    ltpf_num_tab: np.ndarray  # [4, l_num+1]
    ltpf_den_tab: np.ndarray  # [4, l_den+1]
    l_num: int
    l_den: int
    num_mem_blocks: int
    norm: int
    sample_2p5ms: int
    pitch_scale: np.float32  # 8000*ceil(fs/8000)/12800

    @property
    def ne(self):
        return self.cfg.ne

    @property
    def nf(self):
        return self.cfg.nf


@lru_cache(maxsize=None)
def decoder_params(cfg: Lc3Config) -> DecoderParams:
    idx = T.band_indices(cfg)
    widths = np.diff(idx).astype(F32)
    band_of_line = np.zeros(cfg.ne, dtype=np.int32)
    for b in range(cfg.nb):
        band_of_line[idx[b] : idx[b + 1]] = b

    nf_A, nf_B = lcg_jump_tables(31821, 13849, cfg.ne + 1)
    plc_A, plc_B = lcg_jump_tables(12821, 16831, cfg.ne + 1)

    if cfg.n_ms == FrameDuration.MS10:
        bw_stop = np.array([80, 160, 240, 320, 400])
        nf_start, nf_width = 24, 3
        bounds = np.array(
            [
                [[12, 80], [80, 80]],
                [[12, 160], [160, 160]],
                [[12, 240], [240, 240]],
                [[12, 160], [160, 320]],
                [[12, 200], [200, 400]],
            ]
        )
        num_mem, norm = 2, cfg.nf // 4
    else:
        bw_stop = np.array([60, 120, 180, 240, 300])
        nf_start, nf_width = 18, 2
        bounds = np.array(
            [
                [[9, 60], [60, 60]],
                [[9, 120], [120, 120]],
                [[9, 180], [180, 180]],
                [[9, 120], [120, 240]],
                [[9, 150], [150, 300]],
            ]
        )
        num_mem, norm = 3, cfg.nf // 3

    l_den = {8000: 4, 16000: 4, 24000: 6, 32000: 8, 44100: 11, 48000: 12}[cfg.fs]
    l_num = l_den - 2
    num_tab = T.ltpf_num_table(cfg.fs)[:, : l_num + 1].astype(F32)
    den_tab = T.ltpf_den_table(cfg.fs)[:, : l_den + 1].astype(F32)

    return DecoderParams(
        cfg=cfg,
        dct=dct_iv_matrix(cfg.nf),
        window_rev=T.mdct_window(cfg)[::-1].copy(),
        imdct_gain=F32(1.0) / np.sqrt(F32(2.0) * F32(cfg.nf)),
        band_widths=widths,
        band_of_line=band_of_line,
        nf_lcg_A=nf_A,
        nf_lcg_B=nf_B,
        plc_lcg_A=plc_A,
        plc_lcg_B=plc_B,
        bw_stop=bw_stop,
        nf_start=nf_start,
        nf_width=nf_width,
        tns_max_len=int((bounds[:, :, 1] - bounds[:, :, 0]).max()),
        tns_filter_bounds=bounds,
        ltpf_num_tab=num_tab,
        ltpf_den_tab=den_tab,
        l_num=l_num,
        l_den=l_den,
        num_mem_blocks=num_mem,
        norm=norm,
        sample_2p5ms=(48000 if cfg.fs == 44100 else cfg.fs) // 400,
        pitch_scale=F32(8000.0 * np.ceil(cfg.fs / 8000.0) / 12800.0),
    )
