"""Observability for serving loops (the port's copy of lc3jax/metrics.py):
counters and the port's one recorder of spans.

Counters (`CodecMetrics`) are cheap host-side counts fed from values the
pipeline already has (no extra device work): calls, frames decoded and
encoded, concealed frames, audio seconds, the host's reads of a device
value (`host_syncs`, each of which waits for the card), and the calls that
missed their frame's deadline (`late_calls`: a root span longer than the
audio one frame of a stream carries, which the coder passes to `end`).
`reset()` starts a new window.

Spans are a flight recorder, on by default. A span is a `Span` record:
its name, its start and end on the clock of torch.profiler's host events
(`time.time_ns()`, so that a span and a profile of the same call can be
laid side by side), its id, its parent's, the call it belongs to, and
whether a torch.profiler was recording (read once a call, on the root).
A serving call opens a root span (`begin`, `end`), and the spans inside it
(`span`) are closed by one clock read and one append each: the caller
reads the start. A call's spans go into a bounded ring that keeps the
newest RING_CALLS calls; set-up spans (a graph's capture, the kernels'
build and load) are kept whole outside it. On one replay in EDGE_EVERY a
compiled step also times the replay on the card between two CUDA events
(`edge_start`), read only when `spans()` is asked, after the caller has
synchronised. Only a step on the current device is timed: a replay
launches on the current stream of its graph's device, where the events
are recorded.

No span is forwarded into torch.profiler (`record_function`): a range
costs about ten microseconds with no profiler running, and under one it
puts a copy of itself on the card's timeline, which a profile's reader
would count as device activity.

`SPANS_ON = False`, set on this module, stops the hot path's spans and
device edges (to measure what they cost: `tools/span_cost.py`); counters
but `late_calls`, which reads the root span, and set-up spans go on.
"""

from __future__ import annotations

import collections
import itertools
import json
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

RING_CALLS = 2048  # the calls whose spans a recorder keeps, the newest
EDGE_EVERY = 16  # one replay in EDGE_EVERY records its device edges
EDGE_POOL = RING_CALLS // EDGE_EVERY  # pairs of timing events a recorder reuses a device
SPANS_ON = True  # the hot path's spans and device edges; off only to measure their cost


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns(): the clock of torch.profiler's host events
    end_ns: int
    id: int
    parent: int | None
    call: int | None  # the id of the root span of the call it belongs to
    profiled: bool  # a torch.profiler was recording (read on the root)
    key: object = None  # step.capture and its children: the step's key
    device_ms: float | None = None  # a sampled step.replay: the replay's time on the card

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_ids = itertools.count(1)  # span ids, unique in the process
# set-up spans of the process, not of one coder: the kernels' build and load
process_spans: list = []


class SetupSpan:
    """A set-up span, recorded by a `with` block into `into`; `id` is known
    from the start (for the children's `parent`), `span` after the block."""

    def __init__(self, into: list, name: str, parent: int | None = None,
                 call: int | None = None, key=None):
        self.into, self.name, self.parent, self.call, self.key = into, name, parent, call, key
        self.id = next(_ids)
        self.span: Span | None = None

    def __enter__(self) -> "SetupSpan":
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.span = Span(self.name, self.start_ns, time.time_ns(), self.id, self.parent,
                         self.call, _profiler._is_profiler_enabled, self.key)
        self.into.append(self.span)


def process_span(name: str) -> SetupSpan:
    """A set-up span of the process (`process_spans`)."""
    return SetupSpan(process_spans, name)


def _edge_ms(edge) -> float | None:
    """The device ms between a pair's two events, where the pair still holds
    the replay's reading (the pool has not reused it) and both have run."""
    if edge is None:
        return None
    pair, gen = edge
    if pair[2] != gen or not pair[1].query():
        return None
    return pair[0].elapsed_time(pair[1])


@dataclass(slots=True)
class CodecMetrics:
    frames_decoded: int = 0
    frames_encoded: int = 0
    plc_frames: int = 0
    audio_seconds: float = 0.0
    calls: int = 0  # batch calls: one a decode, encode or chunk
    host_syncs: int = 0  # host reads of a device value (each waits for the card)
    late_calls: int = 0  # calls whose root span outlasted the frame passed to `end`
    _start: float = field(default_factory=time.perf_counter)
    # a call's spans: [root id, profiled, (root name, start, end), (name, start, end,
    # id, edge) of each child]; a span outside any call: [None, profiled, None, child]
    _ring: collections.deque = field(default_factory=lambda: collections.deque(maxlen=RING_CALLS),
                                     repr=False, compare=False)
    _setup: list = field(default_factory=list, repr=False, compare=False)
    _open: list | None = field(default=None, repr=False, compare=False)  # the open call's
    _replays: int = field(default=0, repr=False, compare=False)
    _pools: dict = field(default_factory=dict, repr=False, compare=False)  # by device

    def record_decode(self, n_frames: int, frame_seconds: float, n_bad: int = 0):
        self.calls += 1
        self.frames_decoded += n_frames
        self.plc_frames += n_bad
        self.audio_seconds += n_frames * frame_seconds

    def record_encode(self, n_frames: int, frame_seconds: float):
        self.calls += 1
        self.frames_encoded += n_frames
        self.audio_seconds += n_frames * frame_seconds

    def reset(self) -> None:
        """Start a new window: every count to 0 and `wall_seconds` from now.
        The spans are kept."""
        self.frames_decoded = self.frames_encoded = self.plc_frames = 0
        self.calls = self.host_syncs = self.late_calls = 0
        self.audio_seconds = 0.0
        self._start = time.perf_counter()

    # ---------------------------------------------------------- spans

    def begin(self) -> int:
        """Open a call's root span; returns its start for `end`."""
        if not SPANS_ON:
            return 0
        self._open = [next(_ids), _profiler._is_profiler_enabled, None]
        return time.time_ns()

    def span(self, name: str, start_ns: int, edge=None) -> None:
        """Close a span that started at start_ns: a child of the open root,
        or, where none is open, a call of its own."""
        o = self._open
        if o is not None:
            o.append((name, start_ns, time.time_ns(), next(_ids), edge))
        elif SPANS_ON:
            self._ring.append([None, _profiler._is_profiler_enabled, None,
                               (name, start_ns, time.time_ns(), next(_ids), edge)])

    def end(self, name: str, start_ns: int, frame_s: float = float("inf")) -> None:
        """Close the root span opened by `begin` and keep the call's spans;
        count the call late where it took longer than frame_s, the seconds
        of audio one frame of a stream carries."""
        o = self._open
        if o is not None:
            end_ns = time.time_ns()
            o[2] = (name, start_ns, end_ns)
            self._ring.append(o)
            self._open = None
            self.late_calls += end_ns - start_ns > frame_s * 1e9

    def setup(self, name: str, parent: int | None = None, key=None) -> SetupSpan:
        """A set-up span of this recorder, kept outside the ring; `with` it."""
        return SetupSpan(self._setup, name, parent, self._open and self._open[0], key)

    def edge_start(self, device: torch.device):
        """On one replay in EDGE_EVERY of a step on `device`, where that is
        the current device (a replay launches on the current stream of its
        graph's device), never inside a capture and not with spans off:
        record the first of a pair of timing events on the current stream
        and return the edge (the caller records its second event,
        `edge[0][1]`, after the replay and passes the edge to `span`); else
        None. Each device has its own pool of pairs."""
        if not SPANS_ON:
            return None
        self._replays += 1
        if (self._replays % EDGE_EVERY or device.index != torch.cuda.current_device()
                or torch.cuda.is_current_stream_capturing()):
            return None
        pool = self._pools.get(device.index)
        if pool is None:
            pool = self._pools[device.index] = [[torch.cuda.Event(enable_timing=True),
                                                 torch.cuda.Event(enable_timing=True), 0]
                                                for _ in range(EDGE_POOL)]
        pair = pool[self._replays // EDGE_EVERY % EDGE_POOL]
        pair[2] += 1
        pair[0].record()
        return pair, pair[2]

    def spans(self, *names: str, unprofiled: bool = False) -> list:
        """The recorded spans, raw: the process's and this recorder's set-up
        spans, then the ring's calls, oldest first (a call's root before its
        children). Only those named, where names are given; only those of
        calls made with no profiler recording, where asked. A sampled
        replay's `device_ms` is read here: synchronise first."""
        out = [*process_spans, *self._setup]
        for cid, profiled, root, *kids in self._ring:
            if root is not None:
                out.append(Span(*root, cid, None, cid, profiled))
            out.extend(Span(name, a, b, sid, cid, cid, profiled, None, _edge_ms(edge))
                       for name, a, b, sid, edge in kids)
        return [s for s in out if (not names or s.name in names)
                and not (unprofiled and s.profiled)]

    # ---------------------------------------------------------- window

    @property
    def wall_seconds(self) -> float:
        """Host seconds since the recorder was made or last reset."""
        return time.perf_counter() - self._start

    @property
    def realtime_factor(self) -> float:
        """Host wall-clock throughput of the serving loop over the window.

        NOT a device-time measurement: CUDA launches return before the card
        finishes, so time device work with CUDA events (chip_smoke.py)."""
        w = self.wall_seconds
        return self.audio_seconds / w if w > 0 else 0.0

    @property
    def plc_rate(self) -> float:
        return self.plc_frames / self.frames_decoded if self.frames_decoded else 0.0

    def snapshot(self) -> dict:
        return {
            "calls": self.calls,
            "host_syncs": self.host_syncs,
            "late_calls": self.late_calls,
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
