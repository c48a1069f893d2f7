#!/usr/bin/env python3
"""Writes tests/goldens/torch_api.npz: the oracle's output for the streams
that hold lc3jax_torch.api's Lc3Encoder / Lc3Decoder facade to the
reference beyond stream50, so that chip_smoke.py and the port's tests need
neither JAX nor lc3jax:

    JAX_PLATFORMS=cpu python tools/gen_torch_api_goldens.py

- `lossy_*`: stream50's 120 B frames (tests/goldens/stream50.npz) with
  frame LOSSY_CORRUPT replaced by 120 bytes of 0xFF, frame
  LOSSY_TRUNCATED cut to its first 10 bytes and frame LOSSY_EMPTY empty (a
  lost packet delivered as a zero-byte frame): `lossy_payloads` uint8
  [50, 120] (each frame zero-padded), `lossy_nbytes` [50], and the oracle
  decoder's `lossy_pcm_out` int16 [50, 480] and `lossy_concealed` bool
  [50] (the frames it concealed);
- `k16_*`: two channels at 16 kHz / 10 ms, each its own content and frame
  sizes (channel 0 at 40 B, channel 1 at 60, 60, 80, 80 B), each coded by
  a mono oracle encoder and decoder: `k16_pcm_in` int16 [2, 4, 160],
  `k16_nbytes` [2, 4], `k16_payloads` uint8 [2, 4, 80] (zero-padded) and
  `k16_pcm_out` int16 [2, 4, 160].

The oracle is numpy (`lc3jax.ref`): a few seconds on one CPU core.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from lc3jax.config import FrameDuration  # noqa: E402
from lc3jax.ref.decoder import Lc3Decoder  # noqa: E402
from lc3jax.ref.encoder import Lc3Encoder  # noqa: E402

OUT = ROOT / "tests" / "goldens" / "torch_api.npz"
LOSSY_CORRUPT, LOSSY_TRUNCATED, LOSSY_EMPTY = 3, 6, 9
K16_NBYTES = [[40, 40, 40, 40], [60, 60, 80, 80]]


def lossy_frames(payloads: np.ndarray) -> list[bytes]:
    """stream50's frames with the corrupt, truncated and empty frames put in."""
    frames = [bytes(p) for p in payloads]
    frames[LOSSY_CORRUPT] = bytes([255] * len(frames[LOSSY_CORRUPT]))
    frames[LOSSY_TRUNCATED] = frames[LOSSY_TRUNCATED][:10]
    frames[LOSSY_EMPTY] = b""
    return frames


def decode_counting(frames: list[bytes], dec: Lc3Decoder):
    """The oracle's PCM of each frame on channel 0, and which it concealed."""
    ch = dec.channels[0]
    concealed = []
    load_into = ch.plc.load_into

    def counting(x):
        concealed[-1] = True
        return load_into(x)

    ch.plc.load_into = counting
    pcm = []
    for fr in frames:
        concealed.append(False)
        pcm.append(dec.decode_frame(16, 0, fr))
    return np.stack(pcm), np.array(concealed)


def k16_content(channel: int, nf: int, frames: int) -> np.ndarray:
    """Two tones and noise, a different pair a channel, int16 [frames, nf]."""
    rng = np.random.default_rng(11 + channel)
    t = np.arange(nf * frames) / 16000
    sig = (6000 * np.sin(2 * np.pi * (440 + 330 * channel) * t)
           + 3000 * np.sin(2 * np.pi * (2500 + 700 * channel) * t)
           + rng.normal(0, 400, t.size))
    return np.clip(np.round(sig), -32768, 32767).astype(np.int16).reshape(frames, nf)


def main() -> int:
    g = np.load(ROOT / "tests" / "goldens" / "stream50.npz")
    frames = lossy_frames(g["payloads"])
    pcm, concealed = decode_counting(frames, Lc3Decoder(1, FrameDuration.MS10, 48000))
    out = dict(
        lossy_payloads=np.stack([np.pad(np.frombuffer(f, np.uint8), (0, 120 - len(f)))
                                 for f in frames]),
        lossy_nbytes=np.array([len(f) for f in frames]),
        lossy_pcm_out=pcm,
        lossy_concealed=concealed,
        lossy_positions=np.array([LOSSY_CORRUPT, LOSSY_TRUNCATED, LOSSY_EMPTY]),
    )
    nf, T = 160, len(K16_NBYTES[0])
    pcm_in = np.stack([k16_content(c, nf, T) for c in range(2)])
    payloads = np.zeros((2, T, max(map(max, K16_NBYTES))), np.uint8)
    pcm_out = np.zeros_like(pcm_in)
    for c in range(2):
        enc = Lc3Encoder(1, FrameDuration.MS10, 16000)
        dec = Lc3Decoder(1, FrameDuration.MS10, 16000)
        for f, nb in enumerate(K16_NBYTES[c]):
            frame = bytes(enc.encode_frame(0, pcm_in[c, f], nb))
            payloads[c, f, :nb] = np.frombuffer(frame, np.uint8)
            pcm_out[c, f] = dec.decode_frame(16, 0, frame)
    out.update(k16_pcm_in=pcm_in, k16_nbytes=np.array(K16_NBYTES), k16_payloads=payloads,
               k16_pcm_out=pcm_out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: concealed frames {np.flatnonzero(concealed).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
