"""LC3 frame geometry configuration (the reference codec's
`common/config.rs:42-100`): all geometry is static per (sampling
frequency, frame duration) pair.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class SamplingFrequency(enum.IntEnum):
    HZ8000 = 8000
    HZ16000 = 16000
    HZ24000 = 24000
    HZ32000 = 32000
    HZ44100 = 44100
    HZ48000 = 48000


class FrameDuration(enum.Enum):
    MS7P5 = "7.5ms"
    MS10 = "10ms"


_FS_IND = {
    8000: 0,
    16000: 1,
    24000: 2,
    32000: 3,
    44100: 4,  # 44.1 kHz and 48 kHz share index 4 (config.rs:48-49)
    48000: 4,
}

_NF_10MS = {8000: 80, 16000: 160, 24000: 240, 32000: 320, 44100: 480, 48000: 480}
_NF_7P5MS = {8000: 60, 16000: 120, 24000: 180, 32000: 240, 44100: 360, 48000: 360}


@dataclass(frozen=True)
class Lc3Config:
    """Static frame geometry derived from (fs, frame duration).

    Mirrors the fields of the reference Lc3Config (config.rs:17-39):
    fs_ind, fs, ne (spectral lines), n_ms, nb (bands), nf (samples/frame),
    z (leading MDCT-window zeros).
    """

    fs_ind: int
    fs: int
    ne: int
    n_ms: FrameDuration
    nb: int
    nf: int
    z: int

    @staticmethod
    def new(fs: SamplingFrequency | int, n_ms: FrameDuration) -> "Lc3Config":
        fs = int(fs)
        fs_ind = _FS_IND[fs]
        if n_ms == FrameDuration.MS7P5:
            nf = _NF_7P5MS[fs]
            ne = 300 if nf == 360 else nf
            nb = 60 if fs == 8000 else 64
            z = 7 * nf // 30
        else:
            nf = _NF_10MS[fs]
            ne = 400 if nf == 480 else nf
            nb = 64
            z = 3 * nf // 8
        return Lc3Config(fs_ind=fs_ind, fs=fs, ne=ne, n_ms=n_ms, nb=nb, nf=nf, z=z)


ALL_CONFIGS = [
    Lc3Config.new(fs, d)
    for d in (FrameDuration.MS10, FrameDuration.MS7P5)
    for fs in SamplingFrequency
]
