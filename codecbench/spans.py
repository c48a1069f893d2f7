"""What the readers of the program's own spans and counters share
(`metrics/*.host_ms.py`, `*.upload_ms.py`, `*.launch_ms.py`,
`*.replay_device_ms.py`, `setup.*.py`), with the benchmark's own arithmetic:
the program hands over its records raw (`lc3jax_torch.metrics`:
`coder.metrics.spans()`), and the medians, sums and self times are taken
here, so that a later change to the program cannot change how a metric is
computed.

The measured window's calls are the last `len(run.call_ms)` root spans
recorded with no profiler running: the window's calls, after the warm-up
and before the traced sub-window. The recorder keeps the newest 2,048
calls, so in a long window these are its last calls. A program that
records no spans (a recorder without `spans`) gives no reading.
"""

from __future__ import annotations

import statistics
from collections import defaultdict


def _spans(run, *names, unprofiled=False):
    read = getattr(run.coder.metrics, "spans", None)
    return None if read is None else read(*names, unprofiled=unprofiled)


def window_calls(run) -> list | None:
    """The window's calls, oldest first: for each, {span name: [spans]},
    its root under the root's name; None without spans or calls."""
    root = f"serve.{run.direction}"
    spans = _spans(run, unprofiled=True)
    if not spans or len(run.call_ms) == 0:
        return None
    roots = [s for s in spans if s.name == root][-len(run.call_ms):]
    kids = defaultdict(lambda: defaultdict(list))
    for s in spans:
        if s.parent is not None and s.call is not None:
            kids[s.call][s.name].append(s)
    calls = [dict(kids[r.id], **{root: [r]}) for r in roots]
    return calls or None


def median_ms(run, per_call) -> float | None:
    """The median over the window's calls of per_call({name: [spans]}) in
    ms, leaving out the calls where it gives None."""
    calls = window_calls(run)
    vals = [v for v in map(per_call, calls or ()) if v is not None]
    return statistics.median(vals) if vals else None


def total_ms(spans) -> float:
    return sum(s.ms for s in spans)


def host_ms(run) -> float | None:
    """A call's root less its serve.fetch: the host time not spent waiting
    on the card."""
    root = f"serve.{run.direction}"
    return median_ms(run, lambda c: c[root][0].ms - total_ms(c.get("serve.fetch", ())))


def upload_ms(run) -> float | None:
    """serve.upload and step.copy_in of a call."""
    return median_ms(run, lambda c: total_ms(c.get("serve.upload", ()) +
                                             c.get("step.copy_in", ())))


def launch_ms(run) -> float | None:
    """step.replay of a call, on the host (the graph's launch)."""
    return median_ms(run, lambda c: total_ms(c["step.replay"]) if "step.replay" in c else None)


def replay_device_ms(run) -> float | None:
    """The card's time between the two events around a sampled replay (one
    call in 16), over the window's calls that have one; none without a
    card."""
    def one(c):
        dev = [s.device_ms for s in c.get("step.replay", ()) if s.device_ms is not None]
        return sum(dev) if dev else None

    return median_ms(run, one)


def syncs_per_call(run) -> float | None:
    """The coder's host reads of a device value over its calls."""
    m = run.coder.metrics
    calls, syncs = getattr(m, "calls", 0), getattr(m, "host_syncs", None)
    return None if syncs is None or not calls else syncs / calls


def covered_ms(span, others) -> float:
    """The part of span's interval that the union of others covers, in ms."""
    cut = sorted((max(o.start_ns, span.start_ns), min(o.end_ns, span.end_ns)) for o in others)
    ns, end = 0, span.start_ns
    for a, b in cut:
        a = max(a, end)
        if b > a:
            ns, end = ns + b - a, b
    return ns / 1e6


def capture_ms(run) -> float | None:
    """The run's step.capture spans summed, less the kernels' build and load
    inside them (the first capture launches the first kernel, which loads
    the library): those are `kernels_ms`'s."""
    caps = _spans(run, "step.capture")
    if not caps:
        return None
    kernels = _spans(run, "kernels.build", "kernels.load")
    return sum(c.ms - covered_ms(c, kernels) for c in caps)


def kernels_ms(run) -> float | None:
    """The process's kernels.build and kernels.load spans summed."""
    spans = _spans(run, "kernels.build", "kernels.load")
    return total_ms(spans) if spans else None
