"""Minimal PCM16 WAV reader/writer (the port's copy of lc3jax/runner/wav.py;
reference common/wav.rs:45-123).

Canonical 44-byte header; the reader tolerates extra chunks (LIST etc.) by
walking the chunk list to `data`.
"""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (samples int16 [n, channels], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format != 1 or bits != 16:
        raise ValueError(f"only PCM16 supported (fmt={audio_format}, bits={bits})")
    samples = np.frombuffer(pcm, "<i2").reshape(-1, channels)
    return samples, rate


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """samples: int16 [n, channels]."""
    samples = np.asarray(samples, np.int16)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    body = samples.astype("<i2").tobytes()
    byte_rate = rate * channels * 2
    header = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate, byte_rate,
                                    channels * 2, 16)
    header += b"data" + struct.pack("<I", len(body))
    with open(path, "wb") as f:
        f.write(header + body)
