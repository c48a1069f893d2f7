"""The share, in %, of the measured window's `encode` calls that outlast the
audio they carry: the calls whose root span `serve.encode` (the program's
spans, `codecbench/spans.py`) is longer than the configuration's frame,
`frame_ms`. A serving loop that keeps a frame's tick keeps this at 0. None
without spans."""

from codecbench import spans


def read(run):
    calls = spans.window_calls(run)
    if not calls:
        return None
    late = sum(c["serve.encode"][0].ms > run.cfg["frame_ms"] for c in calls)
    return 100.0 * late / len(calls)
