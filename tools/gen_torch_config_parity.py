#!/usr/bin/env python3
"""Writes tests/goldens/torch_config_parity.npz: the oracle's frames and PCM
for the streams that hold lc3jax_torch to the reference beyond the corpus,
so that chip_smoke.py and the port's tests need neither JAX nor lc3jax:

    JAX_PLATFORMS=cpu python tools/gen_torch_config_parity.py

- the ten cases of tests/test_config_parity.py (CASES), 15 frames of its
  `_stream` content each: keys `{fs}_{ms}ms_{nbytes}` (for example
  `8000_7.5ms_30`);
- the 32 kHz click trains of its `test_encoder_parity_32k_attack` at
  10 ms / 100 B and 7.5 ms / 80 B, 12 frames: `attack_32000_{ms}ms_{nbytes}`;
- the per-frame rate plan of tests/test_variable_bitrate.py (RATE_PLAN at
  48 kHz / 10 ms) over its `_stream()` content: `rate_plan`, with the frame
  sizes in `rate_plan_nbytes` and each frame zero-padded to the largest.

Per key: `_pcm_in` int16 [T, nf], `_payloads` uint8 [T, nbytes] (the oracle
encoder's frames, `lc3jax.ref.encoder`) and `_pcm_out` int16 [T, nf] (the
oracle decoder on those frames, `lc3jax.ref.decoder`). The oracle is numpy:
about a minute on one CPU core.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402

from lc3jax.config import FrameDuration, Lc3Config  # noqa: E402
from lc3jax.ref.decoder import Lc3Decoder  # noqa: E402
from lc3jax.ref.encoder import Lc3Encoder  # noqa: E402
from test_config_parity import CASES  # noqa: E402
from test_config_parity import _stream as parity_stream  # noqa: E402
from test_variable_bitrate import CFG as RATE_CFG  # noqa: E402
from test_variable_bitrate import RATE_PLAN  # noqa: E402
from test_variable_bitrate import _stream as rate_stream  # noqa: E402

OUT = ROOT / "tests" / "goldens" / "torch_config_parity.npz"
PARITY_FRAMES = 15
ATTACK_FRAMES = 12


def name_of(cfg: Lc3Config, nbytes: int) -> str:
    return f"{cfg.fs}_{'7.5' if cfg.n_ms == FrameDuration.MS7P5 else '10'}ms_{nbytes}"


def attack_stream(cfg: Lc3Config, nframes: int) -> np.ndarray:
    """The click train of test_encoder_parity_32k_attack: quiet noise with
    full-scale 40-sample bursts every third frame from frame 2."""
    rng = np.random.default_rng(21)
    sig = rng.normal(0, 150, nframes * cfg.nf)
    for k in range(2, nframes, 3):
        pos = k * cfg.nf + cfg.nf // 3
        sig[pos : pos + 40] = 30000.0
    return np.clip(sig, -32768, 32767).astype(np.int16)


def oracle(cfg: Lc3Config, sig: np.ndarray, plan: list[int]):
    """(pcm_in [T, nf], payloads [T, max nbytes], pcm_out [T, nf]) of the
    oracle over sig, frame f coded at plan[f] bytes."""
    enc = Lc3Encoder(1, cfg.n_ms, cfg.fs)
    dec = Lc3Decoder(1, cfg.n_ms, cfg.fs)
    pcm_in = sig[: len(plan) * cfg.nf].reshape(len(plan), cfg.nf)
    payloads = np.zeros((len(plan), max(plan)), np.uint8)
    pcm_out = np.zeros_like(pcm_in)
    for f, nb in enumerate(plan):
        frame = bytes(enc.encode_frame(0, pcm_in[f], nb))
        payloads[f, :nb] = np.frombuffer(frame, np.uint8)
        pcm_out[f] = dec.decode_frame(16, 0, frame)
    return pcm_in, payloads, pcm_out


def main() -> int:
    out = {}

    def put(key, cfg, sig, plan):
        out[f"{key}_pcm_in"], out[f"{key}_payloads"], out[f"{key}_pcm_out"] = oracle(cfg, sig, plan)
        print(key, flush=True)

    for fs, dur, nbytes in CASES:
        cfg = Lc3Config.new(fs, dur)
        put(name_of(cfg, nbytes), cfg, parity_stream(cfg, PARITY_FRAMES), [nbytes] * PARITY_FRAMES)
    for dur, nbytes in ((FrameDuration.MS10, 100), (FrameDuration.MS7P5, 80)):
        cfg = Lc3Config.new(32000, dur)
        put("attack_" + name_of(cfg, nbytes), cfg, attack_stream(cfg, ATTACK_FRAMES),
            [nbytes] * ATTACK_FRAMES)
    put("rate_plan", RATE_CFG, rate_stream(), RATE_PLAN)
    out["rate_plan_nbytes"] = np.asarray(RATE_PLAN, np.int32)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, {len(out)} arrays)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
