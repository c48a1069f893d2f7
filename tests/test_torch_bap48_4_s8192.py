"""The configuration bap48_4.s8192 (BAP 48_4 at 8,192 streams) and its two
cells, `dec.bap48_4.s8192` (the device parse) and
`dec.bap48_4.s8192.hostparse` (the C++ host parse), on the CPU at a few
streams, held to the benchmark's plain reference; the host-parse decode's
spans and the reader of its parse span."""

import time
import types

import numpy as np
import pytest

from codecbench import run, spec
from lc3jax_torch import metrics
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.serving import BatchDecoder

CFG = Lc3Config.new(48000, FrameDuration.MS10)
S, NBYTES = 2, 120
SEED = 2 ** 31 + 23
CELLS = ["dec.bap48_4.s8192", "dec.bap48_4.s8192.hostparse"]
CHILDREN = ["serve.parse", "serve.upload", "step.copy_in", "step.replay", "serve.fetch"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_new_cell_runs_correct_on_the_cpu(cell):
    result, checks, _ = run.run(spec.workload(cell), SEED, 0.5, False, device="cpu", streams=8)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"decode_x_realtime", "setup_s"}
    assert checks["concealed_frames_diff"] == (0, 0)
    assert result["attempted"] > 0 and result["failed"] == 0


class _Clock:
    """A stand-in for time.time_ns that moves only when told."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def __call__(self):
        return self.ns


def test_a_host_parse_decode_records_its_spans_under_one_root(monkeypatch, goldens):
    """One `serve.decode` a call, its children in order, each inside it; the
    parse's span holds the parse's time, and `late_calls` counts the calls
    longer than the 10 ms frame. decode_stream's host parse records its
    spans outside any call."""
    clock = _Clock()
    monkeypatch.setattr(time, "time_ns", clock)
    dec = BatchDecoder(CFG, S, NBYTES, device="cpu", device_parse=False)
    real, took = dec._parser.parse, [0]

    def slow_parse(payloads):
        clock.ns += took[0]  # the parse takes `took` ns on the stand-in clock
        return real(payloads)

    monkeypatch.setattr(dec._parser, "parse", slow_parse)
    pl = goldens("stream50")["payloads"]
    m = dec.metrics
    parse_ms = (9.9, 10.1, 4.0, 25.0)
    for f, ms in enumerate(parse_ms):
        took[0] = int(ms * 1e6)
        dec.decode(np.ascontiguousarray(pl[[f, f + 1]]))
    spans = m.spans()
    roots = [s for s in spans if s.name == "serve.decode"]
    assert len(roots) == len(parse_ms) and all(r.parent is None for r in roots)
    for i, r in enumerate(roots):
        kids = [s for s in spans if s.call == r.id and s is not r]
        # the first call builds the step: no input was copied in
        assert [s.name for s in kids] == [n for n in CHILDREN if i or n != "step.copy_in"]
        assert all(s.parent == r.id for s in kids)
        assert all(r.start_ns <= s.start_ns <= s.end_ns <= r.end_ns for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert kids[0].ms == pytest.approx(parse_ms[i]) and r.ms == pytest.approx(parse_ms[i])
    assert m.late_calls == 2 and m.calls == len(parse_ms)
    assert m.host_syncs == m.calls  # the PCM's fetch, one a call
    took[0] = 0
    n = len(spans)
    dec.decode_stream([np.ascontiguousarray(pl[[5, 6]])])
    new = m.spans()[n:]
    assert {s.name for s in new} == set(CHILDREN)
    assert all(s.call is None and s.parent is None for s in new)


def _recorder(monkeypatch, parse_ms, profiled_at=()):
    """A recorder on a stand-in clock holding one call a parse length in ms
    (None: a call with no serve.parse, as the device parse makes); the calls
    at profiled_at made as if a torch.profiler were recording."""
    clock, m = _Clock(), metrics.CodecMetrics()
    monkeypatch.setattr(time, "time_ns", clock)
    for i, ms in enumerate(parse_ms):
        monkeypatch.setattr(metrics._profiler, "_is_profiler_enabled", i in profiled_at)
        t = m.begin()
        if ms is not None:
            clock.ns += int(ms * 1e6)
            m.span("serve.parse", t)
        m.span("serve.upload", clock.ns)
        m.end("serve.decode", t, 0.01)
    monkeypatch.undo()
    return m


def test_the_host_parse_reader_reads_the_windows_parse_spans(monkeypatch):
    read = spec.reader("decode.host_parse_ms")
    # the window is the last len(call_ms) unprofiled roots: the first call
    # and the profiled one are not in it
    m = _recorder(monkeypatch, [20.0, 3.0, 1.5, 40.0, 2.0], profiled_at=(3,))
    run_ = types.SimpleNamespace(direction="decode", coder=types.SimpleNamespace(metrics=m),
                                 call_ms=np.ones(3))
    assert read(run_) == 2.0  # the median of 3.0, 1.5, 2.0
    run_.coder = types.SimpleNamespace(metrics=_recorder(monkeypatch, [None, None, None]))
    assert read(run_) is None


def test_the_configuration_is_bap48_4_at_8192_streams_with_both_cells():
    small, big = spec.config("bap48_4.s2048"), spec.config("bap48_4.s8192")
    assert {k: big[k] for k in ("fs", "frame_ms", "nbytes")} == {
        k: small[k] for k in ("fs", "frame_ms", "nbytes")}
    assert big["streams"] == 8192 and big["reduced"] == [] and big["name"] == "bap48_4.s8192"
    assert set(big) == set(small)
    bench = spec.benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["bap48_4.s8192"]
    assert entry["file"] == "codecbench/configs/bap48_4.s8192.json" and entry["reduced"] == []
    cells = {w["name"]: w for w in bench["workloads"]}
    assert {c: (cells[c]["config"], cells[c]["traffic"], cells[c]["chips"]) for c in CELLS} == {
        CELLS[0]: ("bap48_4.s8192", "closed.decode", 1),
        CELLS[1]: ("bap48_4.s8192", "closed.decode.hostparse", 1)}
    plain, host = spec.traffic("closed.decode"), spec.traffic("closed.decode.hostparse")
    assert host["coder"]["options"] == {"device_parse": False}
    assert {k: v for k, v in host.items() if k not in ("name", "coder")} == {
        k: v for k, v in plain.items() if k not in ("name", "coder")}
