"""BAP setting 48_1 (LC3 at 48 kHz, 7.5 ms frames, 75 B) through the
port's normal path on the CPU, held to the benchmark's plain reference
(`codecbench.reference`), and the frame-deadline counter and its reader.

At 48_1 two branches of the encoder run that no 10 ms setting at 48 kHz
reaches: the attack detector's 7.5 ms gate (75-149 B) and LTPF activation
(600 bits scale to 800 < 880). The streams below reach both."""

import time
import types

import numpy as np
import pytest
import torch

from codecbench import content, reference, run, spec
from lc3jax_torch import metrics
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.serving import BatchDecoder, BatchEncoder

CFG = Lc3Config.new(48000, FrameDuration.MS7P5)
BENCH_CFG = {"fs": 48000, "frame_ms": 7.5, "nbytes": 75}
NBYTES, FRAMES = 75, 12
SEED = 2 ** 31 + 18
# one clip of each class (content.CLASSES order), then a second look at three
# of them from later offsets: the swept sine (fullscale) holds a pitch long
# enough from its start for LTPF to turn on; the transients' clicks are attacks
CLIP = [0, 1, 2, 3, 4, 4, 2, 0]
OFFSET = [0, 0, 0, 0, 0, 90, 40, 150]


@pytest.fixture(scope="module")
def streams():
    clips, kinds = content.clip_pool(SEED, 1, 200, CFG.nf, CFG.fs)
    assert list(kinds) == list(range(len(content.CLASSES)))
    F = clips.shape[1]
    pcm = np.stack([np.stack([clips[c, (o + b) % F] for c, o in zip(CLIP, OFFSET)])
                    for b in range(FRAMES)])  # [FRAMES, S, nf]
    return clips, pcm


def test_device_pack_encode_equals_the_reference_and_runs_both_branches(streams):
    clips, pcm = streams
    S = len(CLIP)
    packed = BatchEncoder(CFG, S, NBYTES, device="cpu", device_pack=True)
    fields = BatchEncoder(CFG, S, NBYTES, device="cpu")
    out, active, attack = [], [], []
    for b in range(FRAMES):
        out.append(packed.encode(pcm[b]))
        f = fields.encode_fields_tensor(torch.as_tensor(pcm[b]))
        active.append(f["ltpf_ltpf_active"].numpy())
        # the state the call leaves holds this frame's attack position (-1: none)
        attack.append((fields.state.att_pos_last >= 0).numpy())
    jobs = [{"direction": "encode", "cfg": BENCH_CFG, "clip": clips[c], "offset": o,
             "n": FRAMES, "control": False} for c, o in zip(CLIP, OFFSET)]
    want = np.stack([r for r, _ in reference.run_streams(jobs)], axis=1)
    np.testing.assert_array_equal(np.stack(out), want)
    active, attack = np.array(active), np.array(attack)
    assert active.any(), "no stream reached an active LTPF frame"
    assert attack[1:].any(), "no stream reached an attack after its first frame"


def test_the_cell_runs_correct_on_the_cpu():
    result, checks, _ = run.run(spec.workload("enc.bap48_1"), SEED, 0.5, False, device="cpu",
                                streams=8)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"encode_x_realtime", "encode_p95_ms", "setup_s"}
    assert checks["frames_differing"] == (0, 0)


class _Clock:
    """A stand-in for time.time_ns that moves only when told."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def __call__(self):
        return self.ns


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_late_calls_counts_a_call_longer_than_its_frame(monkeypatch, direction):
    clock = _Clock()
    monkeypatch.setattr(time, "time_ns", clock)
    if direction == "encode":
        coder = BatchEncoder(CFG, 1, NBYTES, device="cpu", device_pack=True)
        call, batch = coder.encode, np.zeros((1, CFG.nf), np.int16)
    else:
        coder = BatchDecoder(CFG, 1, NBYTES, device="cpu")
        call, batch = coder.decode, np.zeros((1, NBYTES), np.uint8)
    took = [0]
    real = coder._step

    def slow_step(*a):
        step = real(*a)

        def run(*x):
            clock.ns += took[0]  # the step takes `took` ns on the stand-in clock
            return step.run(*x)

        return types.SimpleNamespace(run=run)

    monkeypatch.setattr(coder, "_step", slow_step)
    m = coder.metrics
    for ms, late in ((7.4, 0), (7.6, 1), (5.0, 1), (30.0, 2)):
        took[0] = int(ms * 1e6)
        call(batch)
        assert m.late_calls == late, ms
    assert m.snapshot()["late_calls"] == 2 and m.calls == 4
    m.reset()
    assert m.late_calls == 0 and m.snapshot()["late_calls"] == 0


def _recorder(monkeypatch, root_ms, profiled_at=()):
    """A recorder holding one call a root length in ms, on a stand-in clock;
    the calls at profiled_at made as if a torch.profiler were recording."""
    clock, m = _Clock(), metrics.CodecMetrics()
    monkeypatch.setattr(time, "time_ns", clock)
    for i, ms in enumerate(root_ms):
        monkeypatch.setattr(metrics._profiler, "_is_profiler_enabled", i in profiled_at)
        t = m.begin()
        m.span("serve.upload", t)
        clock.ns += int(ms * 1e6)
        m.end("serve.encode", t, 7.5e-3)
    monkeypatch.undo()
    return m


def test_the_late_call_reader_reads_the_windows_roots(monkeypatch):
    read = spec.reader("encode.late_call_pct")
    # the window is the last len(call_ms) unprofiled roots: the first call
    # and the profiled one are not in it
    m = _recorder(monkeypatch, [20.0, 5.0, 8.0, 7.4, 30.0, 9.0], profiled_at=(4,))
    assert m.late_calls == 4
    ctx = types.SimpleNamespace(direction="encode", cfg={"frame_ms": 7.5},
                                coder=types.SimpleNamespace(metrics=m), call_ms=np.ones(4))
    assert read(ctx) == 50.0  # 8.0 and 9.0 of 5.0, 8.0, 7.4, 9.0
    ctx.cfg = {"frame_ms": 10}
    assert read(ctx) == 0.0
    bare = types.SimpleNamespace(frames_encoded=0)  # counters only, no spans
    assert read(types.SimpleNamespace(direction="encode", cfg={"frame_ms": 7.5},
                                      coder=types.SimpleNamespace(metrics=bare),
                                      call_ms=np.ones(4))) is None
    ctx.coder = types.SimpleNamespace(metrics=metrics.CodecMetrics())  # spans, but no calls
    assert read(ctx) is None
