"""LC3 spec constant tables.

The numeric data originates from the Bluetooth SIG LC3 specification
(rev 1.0, 2020-09-15), as extracted from the reference implementation's
table modules into data/tables.npz (a copy of the repository's own). Tables
that are derivable from first principles (MPVQ offset triangle, DCT-16
rotation matrix, cumulative frequencies) are regenerated here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .config import FrameDuration, Lc3Config

_DATA = np.load(Path(__file__).parent / "data" / "tables.npz")


def _f32(name: str) -> np.ndarray:
    return np.asarray(_DATA[name], dtype=np.float32)


def _i32(name: str) -> np.ndarray:
    return np.asarray(_DATA[name], dtype=np.int64)


# ---------------------------------------------------------------- MDCT windows
# Low-delay MDCT windows, 2*nf points each (mdct_windows.rs).
_WINDOWS = {
    (FrameDuration.MS10, 80): _f32("W_N80_10MS"),
    (FrameDuration.MS10, 160): _f32("W_N160_10MS"),
    (FrameDuration.MS10, 240): _f32("W_N240_10MS"),
    (FrameDuration.MS10, 320): _f32("W_N320_10MS"),
    (FrameDuration.MS10, 480): _f32("W_N480_10MS"),
    (FrameDuration.MS7P5, 60): _f32("W_N60_7P5MS"),
    (FrameDuration.MS7P5, 120): _f32("W_N120_7P5MS"),
    (FrameDuration.MS7P5, 180): _f32("W_N180_7P5MS"),
    (FrameDuration.MS7P5, 240): _f32("W_N240_7P5MS"),
    (FrameDuration.MS7P5, 360): _f32("W_N360_7P5MS"),
}


def mdct_window(cfg: Lc3Config) -> np.ndarray:
    """Spec low-delay window w_N for this config (length 2*nf, float32)."""
    return _WINDOWS[(cfg.n_ms, cfg.nf)]


# ------------------------------------------------------------- SNS band edges
_BAND_INDICES = {
    (FrameDuration.MS10, 0): _i32("I_8000_10MS"),
    (FrameDuration.MS10, 1): _i32("I_16000_10MS"),
    (FrameDuration.MS10, 2): _i32("I_24000_10MS"),
    (FrameDuration.MS10, 3): _i32("I_32000_10MS"),
    (FrameDuration.MS10, 4): _i32("I_48000_10MS"),
    (FrameDuration.MS7P5, 0): _i32("I_8000_7P5MS"),
    (FrameDuration.MS7P5, 1): _i32("I_16000_7P5MS"),
    (FrameDuration.MS7P5, 2): _i32("I_24000_7P5MS"),
    (FrameDuration.MS7P5, 3): _i32("I_32000_7P5MS"),
    (FrameDuration.MS7P5, 4): _i32("I_48000_7P5MS"),
}


def band_indices(cfg: Lc3Config) -> np.ndarray:
    """I_fs band edge table (nb+1 entries) for this config."""
    return _BAND_INDICES[(cfg.n_ms, cfg.fs_ind)]


# --------------------------------------------------------------- SNS VQ tables
LFCB = _f32("LFCB")  # (32, 8) low-frequency stage-1 codebook
HFCB = _f32("HFCB")  # (32, 8) high-frequency stage-1 codebook
SNS_VQ_REG_ADJ_GAINS = _f32("SNS_VQ_REG_ADJ_GAINS")
SNS_VQ_REG_LF_ADJ_GAINS = _f32("SNS_VQ_REG_LF_ADJ_GAINS")
SNS_VQ_NEAR_ADJ_GAINS = _f32("SNS_VQ_NEAR_ADJ_GAINS")
SNS_VQ_FAR_ADJ_GAINS = _f32("SNS_VQ_FAR_ADJ_GAINS")
SNS_GAIN_MSB_BITS = _i32("SNS_GAIN_MSB_BITS")
SNS_GAIN_LSB_BITS = _i32("SNS_GAIN_LSB_BITS")
SNS_GAINS_BY_SHAPE = [
    SNS_VQ_REG_ADJ_GAINS,
    SNS_VQ_REG_LF_ADJ_GAINS,
    SNS_VQ_NEAR_ADJ_GAINS,
    SNS_VQ_FAR_ADJ_GAINS,
]


def gen_mpvq_offsets(n: int = 16, k: int = 11) -> np.ndarray:
    """MPVQ offset triangle A(n, k) = A(n-1, k) + A(n-1, k-1) + A(n, k-1).

    Row n gives the number of PVQ vectors of dimension n+1 with fewer than
    k pulses and a positive leading sign; derived from the MPVQ enumeration
    recurrence (see spec_noise_shape_quant_tables.rs:290).
    """
    a = np.zeros((n, k), dtype=np.int64)
    a[:, 1] = 1
    a[0, 1:] = 1
    for row in range(1, n):
        for col in range(2, k):
            a[row, col] = a[row - 1, col] + a[row - 1, col - 1] + a[row, col - 1]
    return a


def gen_dct16_matrix() -> np.ndarray:
    """Orthonormal DCT-II basis (column-wise), the SNS stage-2 rotation D.

    D[n][m] = g(m) * cos(pi*(2n+1)*m / 32) with g(0)=sqrt(1/16),
    g(m>0)=sqrt(2/16). Matches spec_noise_shape_quant_tables.rs:310.
    """
    n = np.arange(16)[:, None].astype(np.float64)
    m = np.arange(16)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * n + 1) * m / 32.0)
    d *= np.where(m == 0, np.sqrt(1.0 / 16.0), np.sqrt(2.0 / 16.0))
    return d.astype(np.float32)


MPVQ_OFFSETS = _i32("MPVQ_OFFSETS")  # (16, 11)
DCT16 = _f32("D")  # (16, 16)

# -------------------------------------------------- arithmetic coder models
AC_SPEC_LOOKUP = _i32("AC_SPEC_LOOKUP")  # (4096,) context -> pki
AC_SPEC_FREQ = _i32("AC_SPEC_FREQ")  # (64, 17)
AC_SPEC_CUMFREQ = _i32("AC_SPEC_CUMFREQ")  # (64, 17)
AC_SPEC_BITS = _i32("AC_SPEC_BITS")  # (64, 17)
AC_TNS_ORDER_BITS = _i32("AC_TNS_ORDER_BITS")  # (2, 8)
AC_TNS_ORDER_FREQ = _i32("AC_TNS_ORDER_FREQ")
AC_TNS_ORDER_CUMFREQ = _i32("AC_TNS_ORDER_CUMFREQ")
AC_TNS_COEF_BITS = _i32("AC_TNS_COEF_BITS")  # (8, 17)
AC_TNS_COEF_FREQ = _i32("AC_TNS_COEF_FREQ")
AC_TNS_COEF_CUMFREQ = _i32("AC_TNS_COEF_CUMFREQ")
TNS_NUMFILTERS_MAX = 2
MAXLAG = 8

# --------------------------------------------------------------- LTPF filters
TAB_RESAMP_FILTER = _f32("TAB_RESAMP_FILTER")  # (239,) 12.8k polyphase
TAB_LTPF_INTERP_R = _f32("TAB_LTPF_INTERP_R")  # (31,)
TAB_LTPF_INTERP_X12K8 = _f32("TAB_LTPF_INTERP_X12K8")  # (15,)
_LTPF_NUM = {
    8000: _f32("TAB_LTPF_NUM_8000"),
    16000: _f32("TAB_LTPF_NUM_16000"),
    24000: _f32("TAB_LTPF_NUM_24000"),
    32000: _f32("TAB_LTPF_NUM_32000"),
    44100: _f32("TAB_LTPF_NUM_48000"),  # 44.1k shares the 48k filters
    48000: _f32("TAB_LTPF_NUM_48000"),
}
_LTPF_DEN = {
    8000: _f32("TAB_LTPF_DEN_8000"),
    16000: _f32("TAB_LTPF_DEN_16000"),
    24000: _f32("TAB_LTPF_DEN_24000"),
    32000: _f32("TAB_LTPF_DEN_32000"),
    44100: _f32("TAB_LTPF_DEN_48000"),
    48000: _f32("TAB_LTPF_DEN_48000"),
}


def ltpf_num_table(fs: int) -> np.ndarray:
    return _LTPF_NUM[fs]


def ltpf_den_table(fs: int) -> np.ndarray:
    return _LTPF_DEN[fs]
