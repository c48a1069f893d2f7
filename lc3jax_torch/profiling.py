"""Profiling hooks (port of lc3jax/profiling.py): a trace of a region, a
step's device time and a loop's device span from `torch.profiler`. (The
host's own spans, with no profiler running, are `metrics.py`'s.)

What "device activity" is: on a machine with a card, the card's kernel,
copy and fill intervals on its own clock; on a machine without one, the
host's op intervals (as lc3jax falls back to the host lane), so that the
CPU tests run the same code. On the card only `device_step_ms` records the
host's ops too (it needs each step's host range): recording every eager
op slows a loop that the host's launches bound.

A replayed CUDA graph (`compiled.py`) shows its kernels to the profiler as
eager launches do, one span each (chip_smoke.py phase 11 holds the
kernels it sees in one replay to the eager step's launches), so these
hooks time compiled steps too.

How a profile is read on the card, three guards against faults seen in
chip_smoke.py phase 11 (NVIDIA H100 80GB HBM3, 700.00 W):
- a `mark` range fences the cards and launches an empty edge kernel on
  each at its start and at its end, and its activity is what starts
  between its two edges on the card's own clock. Binning by the host's
  range instead misplaced launches: the card's timestamps, moved onto the
  host's clock, landed up to about a call's length before or after the
  host range that launched them;
- the recording starts after a warm-up step and a margin on the host
  (`MARGIN_S`): without them a profile lost the first 19-27 spans of its
  first call;
- `LEAD_IN` edges go first, and only the last two a range are read: a
  profile of about 41,000 records still lost its first 1-7 records.

On the card nothing here returns a silent 0: a profile that records no
device activity is taken again, and a second empty one raises
(`torch.profiler` has lost every launch of a window once). A
`torch.cuda.synchronize` fences the card, so lc3jax's fence by a
device-to-host fetch and its wait for the collector are not needed.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import tempfile
import time

import torch

from . import _build

STEP_MARK = "lc3jax_torch::step"
MARGIN_S = 0.05  # the host's wait after a recording starts and before it stops
LEAD_IN = 64  # edges on each card before run_fn, more than a profile lost first


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a region under torch.profiler (the host's ops, and the card's
    activity where there is a card) and write a Chrome trace into `log_dir`
    (default: lc3jax_torch-trace in the temp directory):

        with lc3jax_torch.profiling.trace("tr"):
            step(state, frames)

    View it in TensorBoard's profiler plugin, Perfetto or chrome://tracing."""
    from torch.profiler import profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lc3jax_torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities(), on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def _activities(host: bool = True) -> list:
    """The host's ops (where asked, or where there is no card) and the card's."""
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]


def _fence() -> None:
    """Wait for every card's queued work (nothing to wait for on the CPU)."""
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        torch.cuda.synchronize(i)


def _edge() -> None:
    """A range's edge on every card: wait for its queued work, then launch
    the empty edge kernel (`EDGE_KERNEL`) on its current stream (nothing
    on the CPU)."""
    _fence()
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        _build.edge(i)


EDGE_KERNEL = "::spin_kernel("  # in the name of the kernel torch.cuda._sleep launches


@contextlib.contextmanager
def mark(name: str = ""):
    """A `record_function` range that `marked_spans` reads. On the card it
    waits for the work queued before it and for its own work before it
    closes, and its device activity is what starts between its two edge
    kernels; on the CPU it is the host's ops that start inside the range.
    Ranges do not nest."""
    from torch.profiler import record_function

    with record_function(STEP_MARK + name):
        _edge()
        yield
        _edge()


def _profile(run_fn, host: bool = False):
    """run_fn() under torch.profiler between two fences: (activity,
    ranges). activity: the device activity, a sorted list of (start_us,
    end_us, name) on the profiler's clock, edge kernels left out. ranges:
    one (name, spans) per `mark(name)` range run_fn opened, in order, a
    mark's name without the STEP_MARK prefix; None where a card did not
    record two edges a range. The marks need the host's ops recorded
    (`host`)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, schedule

    on_card = torch.cuda.is_available()
    _fence()
    # a warm-up step whose activity is not kept, margins, a lead-in (above)
    with profile(activities=_activities(host),
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        _edge()
        _fence()
        prof.step()
        time.sleep(MARGIN_S if on_card else 0.0)
        for _ in range(LEAD_IN if on_card else 0):
            _edge()
        run_fn()
        _fence()
        time.sleep(MARGIN_S if on_card else 0.0)
    activity = DeviceType.CUDA if on_card else DeviceType.CPU
    spans, marks, edges = [], [], {}
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.name.startswith("ProfilerStep"):  # the schedule's own step range
            continue
        if e.name.startswith(STEP_MARK):  # the host's mark; its copy on the card is no work
            if e.device_type == DeviceType.CPU:
                marks.append((*span[:2], e.name[len(STEP_MARK):]))
        elif e.device_type != activity:
            continue
        elif on_card and EDGE_KERNEL in e.name:
            edges.setdefault(e.device_index, []).append(span[0])
        else:
            spans.append((span, e.device_index))
    marks.sort()
    ranges = [(name, []) for _, _, name in marks]
    if on_card and marks:
        # two edges a range after what is left of the lead-in
        edges = {d: sorted(t)[len(t) - 2 * len(marks):] for d, t in edges.items()
                 if 2 * len(marks) <= len(t) <= 2 * len(marks) + LEAD_IN}
        if any(d not in edges for _, d in spans):
            return sorted(s for s, _ in spans), None
        for span, d in spans:  # between a range's two edges on its own card
            i = bisect.bisect_right(edges[d], span[0]) - 1
            if i >= 0 and i % 2 == 0:
                ranges[i // 2][1].append(span)
    elif marks:
        starts = [a for a, _, _ in marks]
        for span, _ in spans:  # inside a range on the host
            i = bisect.bisect_right(starts, span[0]) - 1
            if i >= 0 and span[0] < marks[i][1]:
                ranges[i][1].append(span)
    for _, r in ranges:
        r.sort()
    return sorted(s for s, _ in spans), ranges


def _read_profile(run_fn, read, host: bool = False):
    """read(*_profile(run_fn, host)), taken once more when it gives None
    (not the activity expected); raises when the second gives None too."""
    for attempt in range(2):
        got = read(*_profile(run_fn, host))
        if got is not None:
            return got
        if attempt == 0:
            print("[profiling] the profile did not record the device activity expected; "
                  "profiling again", flush=True)
    raise RuntimeError("profiling: two profiles did not record the device activity expected")


def device_spans(run_fn, check=None) -> list:
    """The device activity of one run_fn() call: a sorted list of
    (start_us, end_us, name). A profile whose activity is empty, or fails
    check(spans), is taken once more; if that one fails too, this raises."""
    return _read_profile(run_fn, lambda spans, _: spans if spans and (
        check is None or check(spans)) else None)


def union_ms(spans) -> float:
    """ms covered by the union of the spans (each counted once where they
    overlap)."""
    busy, end = 0.0, float("-inf")
    for a, b, *_ in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def device_loop_span_ms(run_fn) -> float:
    """The span of a host-driven loop on the device's clock, in ms: the
    first device event's start to the last one's end, idle gaps included
    (the number for a host-and-device pipeline such as
    `BatchDecoder.decode_stream(pipeline=True)`: frames over this span is
    its throughput). The card is fenced before and after run_fn()."""
    spans = device_spans(run_fn)
    return (max(b for _, b, _ in spans) - spans[0][0]) / 1e3


def marked_spans(run_fn, check=None) -> list:
    """The device activity inside each `mark(name)` range that run_fn()
    opens, under torch.profiler: one (name, spans) per range in the order
    they opened, spans a sorted list of (start_us, end_us, name) (`mark`
    says which). Ranges do not nest. A profile in which a range shows no
    device activity, or that fails check(per_range), is taken once more;
    if that one fails too, this raises."""

    def per_range(_, ranges):
        if ranges is None or not all(s for _, s in ranges) or (
                check is not None and not check(ranges)):
            return None
        return ranges

    return _read_profile(run_fn, per_range, host=True)


def call_spans(fn, calls: int, check=None) -> list:
    """The device activity of each of `calls` calls of fn() under
    torch.profiler, the card synchronised after each call: one sorted list
    of (start_us, end_us, name) per call (`marked_spans`). A profile in
    which a call shows no device activity, or that fails check(per_call),
    is taken once more; if that one fails too, this raises."""

    def run():
        for _ in range(calls):
            with mark():
                fn()

    per = marked_spans(run, lambda per: len(per) == calls and (
        check is None or check([s for _, s in per])))
    return [s for _, s in per]


def device_step_ms(step_fn, init_carry, step_args, steps: int = 10) -> float:
    """A step's device time in ms: the median over `steps` steps of one
    step's device busy time, the union of its kernel, copy and fill
    intervals (one eager step is many kernels, so the union, not the sum of
    their durations).

    Runs `carry, out = step_fn(carry, *step_args)` once to warm up, then
    `steps` times from the warm-up's carry under torch.profiler, the card
    synchronised after each step so that no step's work overlaps another's
    (`call_spans`)."""
    carry, _ = step_fn(init_carry, *step_args)  # warm-up
    _fence()

    def one():
        nonlocal carry
        carry, _ = step_fn(carry, *step_args)

    busy = sorted(union_ms(s) for s in call_spans(one, steps))
    return busy[len(busy) // 2]

