"""Synthetic audio content for the benchmark's streams.

The five content classes of the repository's quality corpus generator,
kept here so that the benchmark owns its traffic: a later change to the
program cannot change what the benchmark sends. Each class makes one clip
of n samples at fs from a numpy Generator:

  speech      1/f-tilted noise, 3.7 Hz syllabic modulation, two pauses
  polyphonic  a detuned three-note chord with overtones and vibrato
  transients  near-silence with clicks and two drum-like bursts
  silence     dither-level noise and a faint tone (about 30 LSB)
  fullscale   a swept sine with noise, clipped at full scale

A pool of 65 clips of 2 s at 48 kHz is made in about a second.
"""

from __future__ import annotations

import numpy as np

CLASSES = ("speech", "polyphonic", "transients", "silence", "fullscale")


def _speech(rng, n, fs):
    a, acc = 0.82, 0.0
    x = []
    for v in rng.standard_normal(n).tolist():  # a one-pole low-pass
        acc = a * acc + (1 - a) * v
        x.append(acc)
    x = np.array(x)
    t = np.arange(n) / fs
    x *= 0.25 + 0.75 * np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.4, 0, 1)
    for p0 in (0.35, 0.72):
        i0 = int(p0 * n)
        x[i0:i0 + int(0.04 * fs)] *= 0.01
    return 52000.0 * x / max(np.abs(x).max(), 1e-9) * 0.35


def _polyphonic(rng, n, fs):
    t = np.arange(n) / fs
    vib = 1.0 + 0.004 * np.sin(2 * np.pi * 5.3 * t)
    x = np.zeros(n)
    for f0, amp in ((220.0, 1.0), (277.18, 0.8), (329.63, 0.9)):
        for h in range(1, 9):
            fh = f0 * h * (vib if h == 1 else 1.0)
            if np.max(fh) >= fs / 2 * 0.95:
                break
            x += (amp / h) * np.sin(2 * np.pi * fh * t + rng.uniform(0, 6.28))
    env = np.minimum(1.0, t * 8.0) * (0.55 + 0.45 * np.cos(2 * np.pi * 0.7 * t) ** 2)
    return 17000.0 * x / np.abs(x).max() * env


def _transients(rng, n, fs):
    x = 25.0 * rng.standard_normal(n)
    period = max(int(0.09 * fs), 8)
    for i0 in range(period // 2, n - 64, period):
        x[i0] += rng.choice([-1, 1]) * 30000.0  # a click of one sample
    for p0 in (0.3, 0.75):  # two bursts of decaying noise
        i0 = int(p0 * n)
        ln = min(int(0.05 * fs), n - i0)
        x[i0:i0 + ln] += 24000.0 * rng.standard_normal(ln) * np.exp(-np.arange(ln) / (0.008 * fs))
    return x


def _silence(rng, n, fs):
    t = np.arange(n) / fs
    return 18.0 * rng.standard_normal(n) + 12.0 * np.sin(2 * np.pi * 313.0 * t)


def _fullscale(rng, n, fs):
    t = np.arange(n) / fs
    f_hi = min(6000.0, fs * 0.35)
    sweep = np.sin(2 * np.pi * (80.0 * t + 0.5 * (f_hi - 80.0) / max(t[-1], 1e-9) * t ** 2))
    return 36000.0 * sweep + 4000.0 * rng.standard_normal(n)  # clips on purpose


_MAKERS = {"speech": _speech, "polyphonic": _polyphonic, "transients": _transients,
           "silence": _silence, "fullscale": _fullscale}


def clip(kind: str, rng: np.random.Generator, frames: int, nf: int, fs: int) -> np.ndarray:
    """One clip of `frames` frames of class `kind`: int16 [frames, nf]."""
    x = _MAKERS[kind](rng, frames * nf, fs)
    return np.clip(x, -32768, 32767).astype(np.int16).reshape(frames, nf)


def clip_pool(seed: int, per_class: int, frames: int, nf: int, fs: int):
    """`per_class` clips of each class, made from `seed`: (int16 [C, frames,
    nf], the class index of each clip [C]), clips in class order."""
    clips, kinds = [], []
    for k, kind in enumerate(CLASSES):
        for i in range(per_class):
            rng = np.random.default_rng([seed, k, i])
            clips.append(clip(kind, rng, frames, nf, fs))
            kinds.append(k)
    return np.stack(clips), np.asarray(kinds, np.int64)
