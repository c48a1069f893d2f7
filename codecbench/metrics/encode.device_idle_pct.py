"""Share of the time in which the card ran nothing, in percent: 1 less its
busy time a batch in the traced sub-window (the union of its kernel, copy
and fill spans, `codecbench/trace.py`) over the measured window's time a
batch (the host's clock: the profiler itself slows the loop)."""


def read(run):
    p = run.profile
    return 100.0 * (1.0 - (p.busy_ms / p.batches) / run.window_ms_per_batch)
