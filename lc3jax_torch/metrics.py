"""Lightweight observability for serving loops (the port's copy of
lc3jax/metrics.py).

Cheap host-side counters fed from values the pipeline already has (no extra
device work): frames decoded and encoded, concealed frames, audio seconds.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class CodecMetrics:
    frames_decoded: int = 0
    frames_encoded: int = 0
    plc_frames: int = 0
    audio_seconds: float = 0.0
    _start: float = field(default_factory=time.perf_counter)

    def record_decode(self, n_frames: int, frame_seconds: float, n_bad: int = 0):
        self.frames_decoded += n_frames
        self.plc_frames += n_bad
        self.audio_seconds += n_frames * frame_seconds

    def record_encode(self, n_frames: int, frame_seconds: float):
        self.frames_encoded += n_frames
        self.audio_seconds += n_frames * frame_seconds

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self._start

    @property
    def realtime_factor(self) -> float:
        """Host wall-clock throughput of the serving loop.

        NOT a device-time measurement: CUDA launches return before the card
        finishes, so time device work with CUDA events (chip_smoke.py)."""
        w = self.wall_seconds
        return self.audio_seconds / w if w > 0 else 0.0

    @property
    def plc_rate(self) -> float:
        return self.plc_frames / self.frames_decoded if self.frames_decoded else 0.0

    def snapshot(self) -> dict:
        return {
            "frames_decoded": self.frames_decoded,
            "frames_encoded": self.frames_encoded,
            "plc_frames": self.plc_frames,
            "plc_rate": round(self.plc_rate, 6),
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            "realtime_factor": round(self.realtime_factor, 1),
        }

    def dumps(self) -> str:
        return json.dumps(self.snapshot())
