"""The one traffic generator: a mix file's parameters and a seed make every
input of a run.

Each stream plays one clip from its start offset: at batch b it sends
frame (offset + b) mod F of its clip, so the loop runs as long as the
window needs, and every F batches the inputs repeat. The seed draws each
stream's clip and offset; the number of streams of each content class
is the same for every seed (the mix's shares, rounded by largest
remainder), in another order, so that seeds change which streams carry
what, not how much of each there is.

Decode mixes take their clips from a committed frame corpus made by the
reference encoder (`make_corpus.py`); encode mixes make their PCM clips
from the seed (`content.clip_pool`).
"""

from __future__ import annotations

import numpy as np

from . import content, spec
from .reference import lc3_config

MASK64 = (1 << 64) - 1


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & MASK64, *tags])


def class_counts(shares: dict, n: int) -> np.ndarray:
    """Streams of each class (content.CLASSES order): the shares of n,
    rounded by largest remainder so that they sum to n."""
    p = np.array([shares.get(k, 0.0) for k in content.CLASSES], np.float64)
    want = p / p.sum() * n
    counts = np.floor(want).astype(np.int64)
    extra = np.argsort(-(want - counts), kind="stable")[: n - counts.sum()]
    counts[extra] += 1
    return counts


class Traffic:
    """A run's inputs: `clips` ([C, F, ...] frames or PCM), each stream's
    `clip` and `offset`, the `checked` streams, and `batch(b)`, the
    [streams, ...] array sent at batch b (the F distinct batches are made
    once, in set-up)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, streams: int):
        self.cfg, self.mix, self.streams = cfg, mix, streams
        F = mix["frames_per_clip"]
        if mix["direction"] == "decode":
            with np.load(spec.corpus_path(cfg, mix)) as z:
                self.clips, kinds = z["frames"], z["kinds"]
                self.concealed = z["concealed"]
        else:
            self.clips, kinds = content.clip_pool(seed, mix["clips_per_class"], F,
                                                  lc3_config(cfg).nf, cfg["fs"])
            self.concealed = None
        if self.clips.shape[1] != F:
            raise ValueError(f"clips of {self.clips.shape[1]} frames, the mix says {F}")
        r = rng(seed, 1)
        counts = class_counts(mix["shares"], streams)
        stream_kind = r.permutation(np.repeat(np.arange(len(counts)), counts))
        self.clip = np.empty(streams, np.int64)
        for k in range(len(counts)):
            ours = np.flatnonzero(kinds == k)
            at = stream_kind == k
            self.clip[at] = ours[r.integers(0, len(ours), int(at.sum()))]
        self.offset = r.integers(0, F, streams)
        n_check = min(mix["checked_streams"], streams)
        self.checked = np.sort(r.choice(streams, n_check, replace=False))
        b = np.arange(F)[:, None]
        self._batches = np.ascontiguousarray(self.clips[self.clip[None, :],
                                                        (self.offset[None, :] + b) % F])

    @property
    def period(self) -> int:
        return self._batches.shape[0]

    def batch(self, b: int) -> np.ndarray:
        return self._batches[b % self.period]

    def concealed_frames(self, n: int) -> int:
        """Frames the reference decoder conceals in batches 0..n-1 (decode)."""
        F = self.period
        frame = (self.offset[None, :] + np.arange(F)[:, None]) % F
        per_batch = self.concealed[self.clip[None, :], frame].sum(1)
        full, rest = divmod(n, F)
        return int(full * per_batch.sum() + per_batch[:rest].sum())
