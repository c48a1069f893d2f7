"""lc3jax_torch.metrics on the CPU: the spans a serving call records (their
tree, their clock against torch.profiler's, the profiled flag), the ring's
bound, the off switch, the counters' window and host reads, the sampled
device edges' bookkeeping and the kernels' build span."""

import os
import stat
import time

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from lc3jax_torch import _build, metrics
from lc3jax_torch.compiled import CompiledStep
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.serving import BatchDecoder, BatchEncoder

CFG = Lc3Config.new(16000, FrameDuration.MS10)
S, NBYTES = 2, 40
CHILDREN = {"decode": ["serve.upload", "step.copy_in", "step.replay", "serve.fetch",
                       "serve.plc_count"],
            "encode": ["serve.upload", "step.copy_in", "step.replay", "serve.fetch"]}


def _coder(direction):
    """(a coder on the CPU, its call, one batch), the call made once (the
    first builds the step, so it copies no input)."""
    if direction == "decode":
        c = BatchDecoder(CFG, S, NBYTES, device="cpu")
        call, batch = c.decode, np.arange(S * NBYTES, dtype=np.uint8).reshape(S, NBYTES)
    else:
        c = BatchEncoder(CFG, S, NBYTES, device="cpu", device_pack=True)
        call, batch = c.encode, (np.arange(S * CFG.nf) % 2000 - 1000).astype(np.int16).reshape(
            S, CFG.nf)
    call(batch)
    return c, call, batch


@pytest.fixture(scope="module")
def decoder():
    return _coder("decode")


def _last_call(m: metrics.CodecMetrics, root: str):
    """The last call's root and its children, in the order they started."""
    spans = m.spans()
    r = [s for s in spans if s.name == root][-1]
    return r, sorted((s for s in spans if s.call == r.id and s is not r), key=lambda s: s.start_ns)


@pytest.mark.parametrize("direction", ["decode", "encode"])
def test_a_calls_spans_form_one_tree_inside_its_root(direction):
    c, call, batch = _coder(direction)
    call(batch)
    root, kids = _last_call(c.metrics, f"serve.{direction}")
    assert root.parent is None and root.call == root.id and not root.profiled
    assert [s.name for s in kids] == CHILDREN[direction]
    assert all(s.parent == root.id and s.call == root.id for s in kids)
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))  # one after another
    assert len({s.id for s in c.metrics.spans()}) == len(c.metrics.spans())
    assert all(s.device_ms is None for s in kids)  # no device edges without a card
    # the first call built the step: no input was copied in
    first = [s for s in c.metrics.spans() if s.name == f"serve.{direction}"][0]
    assert "step.copy_in" not in {s.name for s in c.metrics.spans() if s.call == first.id}


def test_spans_lie_on_the_profilers_clock(decoder):
    """A root span lies within a record_function range around the same call,
    both on torch.profiler's host clock, to 50 microseconds."""
    c, call, batch = decoder
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe"):
            call(batch)
    probe = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert len(probe) == 1
    a, b = probe[0].start_ns(), probe[0].start_ns() + probe[0].duration_ns()
    root, _ = _last_call(c.metrics, "serve.decode")
    assert a - 50_000 <= root.start_ns < root.end_ns <= b + 50_000, (a, b, root)


def test_the_root_says_whether_a_profiler_recorded(decoder):
    c, call, batch = decoder
    with profile(activities=[ProfilerActivity.CPU]):
        call(batch)
    call(batch)
    roots = c.metrics.spans("serve.decode")
    assert roots[-2].profiled and not roots[-1].profiled
    assert all(s.profiled for s in c.metrics.spans() if s.call == roots[-2].id)
    unprofiled = c.metrics.spans("serve.decode", unprofiled=True)
    assert roots[-2] not in unprofiled and roots[-1] in unprofiled


def test_the_ring_keeps_its_bound_and_the_setup_spans():
    m = metrics.CodecMetrics()
    with m.setup("step.capture", key="k") as cap:
        with m.setup("step.warmup", cap.id, "k"):
            pass
    n = metrics.RING_CALLS + 50
    for _ in range(n):
        t = m.begin()
        m.span("step.replay", time.time_ns())
        m.end("serve.decode", t)
    assert metrics.RING_CALLS >= 2000
    roots = m.spans("serve.decode")
    assert len(roots) == metrics.RING_CALLS
    assert len(m.spans("step.replay")) == metrics.RING_CALLS
    assert [s.name for s in m.spans()[:2]] == ["step.warmup", "step.capture"]
    warm, capture = m.spans()[:2]
    assert warm.parent == capture.id and capture.parent is None and capture.key == "k"
    assert roots[-1].id > roots[0].id  # the newest kept, in order


def test_the_off_switch_records_nothing(monkeypatch):
    c, call, batch = _coder("decode")
    before = len(c.metrics.spans())
    monkeypatch.setattr(metrics, "SPANS_ON", False)
    call(batch)
    call(batch)
    assert len(c.metrics.spans()) == before
    assert c.metrics.calls == 3  # the counters go on


def test_reset_restarts_the_window(decoder):
    c, call, batch = decoder
    m = c.metrics
    call(batch)
    kept = len(m.spans())
    t_sleep = time.perf_counter()
    time.sleep(0.05)
    m.reset()
    assert m.calls == m.host_syncs == m.frames_decoded == m.plc_frames == 0
    assert m.audio_seconds == 0
    call(batch)
    assert m.calls == 1 and m.frames_decoded == S
    # the window began at the reset, after the sleep
    assert m.wall_seconds <= time.perf_counter() - t_sleep - 0.05
    assert m.realtime_factor == pytest.approx(m.audio_seconds / m.wall_seconds, rel=0.5)
    assert len(m.spans()) > kept  # spans are kept across a reset


@pytest.mark.parametrize("direction, per_call", [("decode", 2), ("encode", 1)])
def test_host_syncs_count_each_host_read(direction, per_call):
    c, call, batch = _coder(direction)
    call(batch)
    assert c.metrics.calls == 2 and c.metrics.host_syncs == 2 * per_call
    assert c.metrics.snapshot()["host_syncs"] == 2 * per_call


def test_a_step_outside_a_serving_call_records_its_own_spans():
    step = CompiledStep(lambda st, x: (st + x, st * 2), "toy", "cpu")
    st, _ = step(torch.zeros(3), torch.ones(3))
    step(st, torch.ones(3))
    spans = step.cache.metrics.spans()
    assert [s.name for s in spans] == ["step.replay", "step.copy_in", "step.replay"]
    assert all(s.parent is None and s.call is None for s in spans)
    assert step.graphs[0].capture_ms == 0.0  # nothing captured on the CPU


class _Event:
    """A stand-in for torch.cuda.Event that reads a host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _Card:
    """A stand-in for torch.cuda's current device and its capture state."""

    current = 0
    capturing = False

    @classmethod
    def current_device(cls):
        return cls.current


def _replay(m, device):
    t = m.begin()
    edge = m.edge_start(device)
    if edge is not None:
        edge[0][1].record()
    m.span("step.replay", t, edge)
    m.end("serve.decode", t)
    return edge


def test_device_edges_are_sampled_and_read_from_the_pool(monkeypatch):
    monkeypatch.setattr(metrics.torch.cuda, "Event", _Event)
    monkeypatch.setattr(metrics.torch.cuda, "current_device", _Card.current_device)
    monkeypatch.setattr(metrics.torch.cuda, "is_current_stream_capturing",
                        lambda: _Card.capturing)
    m = metrics.CodecMetrics()
    n = metrics.EDGE_EVERY * (metrics.EDGE_POOL + 3)
    for _ in range(n):
        _replay(m, torch.device("cuda", 0))
    replays = m.spans("step.replay")
    sampled = [s for s in replays if s.device_ms is not None]
    # one in EDGE_EVERY; the pool's pairs reused, so only the newest readings stay
    assert len(sampled) == metrics.EDGE_POOL
    assert all(s.device_ms >= 0 for s in sampled)
    assert replays[-1].device_ms is not None
    # a step on another card than the current one is not timed (its replay
    # runs on that card's stream); with its card current, from a pool of its own
    assert all(_replay(m, torch.device("cuda", 1)) is None for _ in range(2 * metrics.EDGE_EVERY))
    monkeypatch.setattr(_Card, "current", 1)
    edges = [e for e in (_replay(m, torch.device("cuda", 1))
                         for _ in range(metrics.EDGE_EVERY)) if e is not None]
    assert len(edges) == 1
    assert all(edges[0][0] is not pair for pair in m._pools[0])
    monkeypatch.setattr(_Card, "capturing", True)
    assert all(m.edge_start(torch.device("cuda", 1)) is None
               for _ in range(2 * metrics.EDGE_EVERY))


def test_the_kernels_build_is_a_process_span(monkeypatch, tmp_path):
    """A stand-in nvcc that writes each output: build() records one
    `kernels.build` span, whose duration is `build_seconds`."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = -o ]; then : > "$2"; fi\n'
                    '  shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_seconds", None)
    monkeypatch.setattr(metrics, "process_spans", [])
    out = _build.build()
    assert out.exists() and os.path.dirname(out) == str(tmp_path / "build")
    (built,) = metrics.process_spans
    assert built.name == "kernels.build" and built.parent is None
    assert _build.build_seconds == built.ms / 1e3 > 0
    assert built in metrics.CodecMetrics().spans("kernels.build")
    _build.build()  # the hashed library is there: no second build
    assert len(metrics.process_spans) == 1
