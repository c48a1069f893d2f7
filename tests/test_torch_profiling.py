"""lc3jax_torch.profiling on the CPU, where "device activity" is the host's
op intervals (lc3jax's host-lane fallback): a trace file is written, a
step's busy time lies within its host wall, a loop's span covers its
steps, and an empty profile is taken again and then raises."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lc3jax_torch import profiling


def _imdct_step():
    """(step_fn, init_carry, step_args): the decoder's IMDCT and overlap-add
    at 48 kHz / 10 ms over 4 streams, the carry its OLA memory."""
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import decoder_tables
    from lc3jax_torch.dsp.decoder import imdct_ola

    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    tab = decoder_tables(cfg, 1200, "cpu")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((4, cfg.ne)).astype(np.float32))
    mem = torch.zeros(4, cfg.nf - cfg.z)
    return (lambda m, spec: imdct_ola(tab, spec, m)[::-1]), mem, (x,)


def test_trace_writes_a_trace_file(tmp_path):
    step, mem, args = _imdct_step()
    with profiling.trace(str(tmp_path)) as d:
        step(mem, *args)
    assert d == str(tmp_path)
    files = list(Path(d).glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_device_step_ms_within_host_wall():
    """The median busy time of a step is > 0 and no more than the median
    host wall of the same profiled steps (each step's op intervals lie
    inside its wall)."""
    step, mem, args = _imdct_step()
    walls = []

    def timed(m, *a):
        t0 = time.perf_counter()
        out = step(m, *a)
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    ms = profiling.device_step_ms(timed, mem, args, steps=5)
    profiled = sorted(walls[1:])  # after the warm-up
    assert len(profiled) == 5
    assert 0.0 < ms <= profiled[len(profiled) // 2]


def test_device_loop_span_covers_its_steps():
    """The span of a 4-step loop, from its first op's start to its last
    op's end, is at least the longest inner step's host wall (each lies
    between the two) and a step's busy time, and no more than the loop's
    host wall."""
    step, mem, args = _imdct_step()
    one = profiling.device_step_ms(step, mem, args, steps=3)
    walls = []

    def loop():
        start, m = time.perf_counter(), mem
        for _ in range(4):
            t0 = time.perf_counter()
            m, _ = step(m, *args)
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.append((time.perf_counter() - start) * 1e3)

    span = profiling.device_loop_span_ms(loop)
    assert max(one, *walls[1:3]) <= span <= walls[-1]


def test_profile_without_the_expected_activity_raises():
    """A profile that does not record the activity expected is taken once
    more; a second such profile raises instead of returning 0."""
    calls = []
    with pytest.raises(RuntimeError, match="two profiles"):
        profiling.device_spans(lambda: calls.append(torch.ones(3) + 1), check=lambda s: False)
    assert len(calls) == 2
    spans = profiling.device_spans(lambda: torch.ones(3) + 1)
    assert spans and all(a <= b for a, b, _ in spans)


def test_union_ms_counts_overlaps_once():
    assert profiling.union_ms([(0, 1000, "a"), (500, 1500, "b"), (3000, 3500, "c")]) == 2.0
    assert profiling.union_ms([]) == 0.0
