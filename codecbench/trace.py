"""The traced sub-window of a `--trace 1` run, read from `torch.profiler`,
with the benchmark's own interval arithmetic (later changes to the
program cannot change how it is measured).

One short profile of the same closed loop, after the measured window,
recording the card's activity (kernels, copies, fills) and the host's ops
together:

- the card's busy time is the union of its spans; each kernel's summed
  time by name; the sub-window's length on the host's clock, from just
  before its first batch to just after its last, the card fenced at both
  ends;
- each idle gap of the card is named by what the host was doing in it
  (the innermost op that covers half the gap or more).

The profiler slows the loop: a replay of the encoder's ~5,800-node graph
took about twice as long under it on the H100, so the idle share is taken
against the measured window's time a batch (`metrics/*.device_idle_pct.py`),
not the profiled sub-window's; the card's busy time and the kernels' times
are its own. The profile records after a warm-up step and a margin:
without them, profiles of the program's steps on the H100 lost the first
spans of their first call. Its cost is mostly fixed (the profiler's start
and stop), so a run takes one profile, not one for the card and one for
the host.
"""

from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict

MARGIN_S = 0.05


def merged(spans) -> list:
    """The union of (start_us, end_us, ...) spans as sorted disjoint (start, end)."""
    out: list = []
    for a, b, *_ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Profile:
    """What one traced sub-window read."""

    batches: int
    window_ms: float  # host clock, first batch to the fence after the last
    busy_ms: float  # the union of the card's spans
    kernel_ms: dict  # name -> summed device ms
    idle_gaps: dict = dataclasses.field(default_factory=dict)  # host op -> idle ms

    def kernel_total_ms(self, pattern: str) -> float | None:
        """Summed ms of the kernels whose name has `pattern` as a word
        (None where no such kernel ran)."""
        rx = re.compile(rf"\b{re.escape(pattern)}\b")
        hits = [ms for name, ms in self.kernel_ms.items() if rx.search(name)]
        return sum(hits) if hits else None


def _record(one_batch, batches: int, on_card: bool):
    """Profiles `batches` calls of one_batch(), the host's ops and (on a
    card) the card's activity; returns (window_ms, events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            one_batch()
        sync()
        prof.step()
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(batches):
            one_batch()
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(MARGIN_S)
    # the profiler's raw records: the event list would fold a graph's
    # kernels into the host op that launched them
    events = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name(),
               e.device_type()) for e in prof.profiler.kineto_results.events()
              if not e.name().startswith("ProfilerStep")]
    return window_ms, events


def profile_loop(one_batch, batches: int, on_card: bool) -> Profile:
    """The profile of `batches` calls (see the module's docstring). On a
    machine without a card (the benchmark's CPU tests) the host's ops stand
    in for the card's activity."""
    from torch.autograd import DeviceType

    dev = DeviceType.CUDA if on_card else DeviceType.CPU
    window_ms, events = _record(one_batch, batches, on_card)
    spans = [(a, b, name) for a, b, name, d in events if d == dev]
    kernel_ms: dict = defaultdict(float)
    for a, b, name in spans:
        kernel_ms[name] += (b - a) / 1e3
    busy_ms = sum(b - a for a, b in merged(spans)) / 1e3  # each instant once
    prof = Profile(batches, window_ms, busy_ms, dict(kernel_ms))
    if on_card:
        prof.idle_gaps = _idle_gaps(events)
    return prof


def _idle_gaps(events) -> dict:
    """Idle ms of the card between its busy spans, by the host op that
    covered each gap (the innermost covering half of it or more)."""
    from torch.autograd import DeviceType

    dev = [(a, b) for a, b, _, d in events if d == DeviceType.CUDA]
    host = sorted((a, b, name) for a, b, name, d in events if d == DeviceType.CPU)
    busy = merged(dev)
    out: dict = defaultdict(float)
    i, active = 0, []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while i < len(host) and host[i][0] < b:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > a]
        best = None
        for s, e, name in active:
            if min(e, b) - max(s, a) >= (b - a) / 2 and (best is None or e - s < best[0]):
                best = (e - s, name)
        out["host outside any op" if best is None else best[1]] += (b - a) / 1e3
    return dict(out)


def breakdown(prof: Profile) -> dict:
    """The traced run's `breakdown`: the ten kernels that took the most
    device time and the ten host ops under the most idle time, in seconds."""
    top = lambda d: [[k, v / 1e3] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(prof.kernel_ms), "idle_gaps": top(prof.idle_gaps)}
