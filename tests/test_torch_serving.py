"""lc3jax_torch.serving.BatchDecoder's host-parse mode and decode_stream on
the CPU, in the pattern of tests/test_serving.py (lc3jax's serving tests),
against the port's fused decode and the stored oracle PCM."""

import threading

import numpy as np
import pytest

from lc3jax_torch import serving
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.serving import BatchDecoder

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
S, NBYTES, NFRAMES, BAD = 2, 120, 5, (2, 1)  # the frame and stream made corrupt


@pytest.fixture(scope="module")
def stream(goldens):
    """stream50's first frames on S = 2 streams (stream 1 delayed by one
    frame), frame 2 of stream 1 overwritten with 0xFF bytes; the fused
    decode of each batch in turn; stream50's oracle PCM."""
    g = goldens("stream50")
    pl = g["payloads"]
    batches = [np.stack([pl[f], pl[max(f - 1, 0)]]) for f in range(NFRAMES)]
    batches[BAD[0]][BAD[1]] = 255
    fused = BatchDecoder(CFG48, S, NBYTES, device="cpu")
    want = [fused.decode(b) for b in batches]
    assert fused.metrics.plc_frames == 1
    return batches, want, g["pcm_out"]


@pytest.fixture(scope="module")
def host_seq(stream):
    batches, _, _ = stream
    dec = BatchDecoder(CFG48, S, NBYTES, device="cpu", device_parse=False)
    return [dec.decode(b) for b in batches], dec.metrics


def test_host_parse_decode_equals_fused_decode(stream, host_seq):
    """The C++ parser zeroes a bad frame's fields, the plain parser keeps
    some: PLC reads neither, so the PCM is equal, the corrupt frame's too."""
    batches, want, pcm_out = stream
    got, metrics = host_seq
    for f in range(NFRAMES):
        assert got[f].dtype == np.int16 and np.array_equal(got[f], want[f]), f
    assert metrics.frames_decoded == S * NFRAMES and metrics.plc_frames == 1
    assert abs(metrics.audio_seconds - S * NFRAMES * 0.01) < 1e-9
    pcm = np.stack(got)[:, 0].astype(int)  # stream 0 is stream50 itself
    assert np.abs(pcm - pcm_out[:NFRAMES]).max() <= 1


def test_pipelined_decode_stream_matches_sequential(stream, host_seq):
    batches, _, _ = stream
    dec = BatchDecoder(CFG48, S, NBYTES, device="cpu", device_parse=False)
    piped = dec.decode_stream(iter(batches), pipeline=True)
    assert len(piped) == NFRAMES
    assert all(np.array_equal(a, b) for a, b in zip(piped, host_seq[0]))
    assert dec.metrics.plc_frames == 1 and dec.metrics.frames_decoded == S * NFRAMES
    seq = BatchDecoder(CFG48, S, NBYTES, device="cpu", device_parse=False)
    assert all(np.array_equal(a, b) for a, b in zip(seq.decode_stream(iter(batches)), piped))
    assert seq.metrics.plc_frames == 1


def test_pipelined_decode_stream_propagates_producer_error(stream):
    """A failure on the prefetch thread raises in the caller, not a hang,
    and the thread has ended when it does."""
    batches, _, _ = stream

    def source():
        yield batches[0]
        yield batches[1]
        raise RuntimeError("upstream source failed")

    dec = BatchDecoder(CFG48, S, NBYTES, device="cpu", device_parse=False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="upstream source failed"):
        dec.decode_stream(source(), pipeline=True)
    assert threading.active_count() == before
    assert dec.metrics.frames_decoded == 2 * S  # the two batches before the error
    with pytest.raises(ValueError, match="expected payloads"):  # a bad shape, on the thread
        dec.decode_stream(iter([batches[0][:1]]), pipeline=True)


def test_pipelined_decode_stream_stops_the_producer_on_a_decode_error(stream, monkeypatch):
    """A failure in the decode raises in the caller, and the prefetch thread
    stops reading the source and ends."""
    batches, _, _ = stream
    read = []

    def source():
        for b in batches * 4:
            read.append(1)
            yield b

    def fail(*args):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(serving, "decode_step", fail)
    dec = BatchDecoder(CFG48, S, NBYTES, device="cpu", device_parse=False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="decode failed"):
        dec.decode_stream(source(), pipeline=True)
    assert threading.active_count() == before
    assert len(read) < 4 * NFRAMES


@pytest.mark.parametrize("fetch", [True, False])
def test_device_parse_decode_stream(stream, fetch):
    """fetch=True: numpy PCM and the concealed frames counted on the device;
    fetch=False: tensors, plc_frames not tracked. pipeline is ignored."""
    batches, want, _ = stream
    n = BAD[0] + 1
    dec = BatchDecoder(CFG48, S, NBYTES, device="cpu")
    outs = dec.decode_stream(iter(batches[:n]), fetch=fetch, pipeline=True)
    assert len(outs) == n
    for f, out in enumerate(outs):
        assert isinstance(out, np.ndarray) == fetch
        assert np.array_equal(out if fetch else out.numpy(), want[f]), f
    assert dec.metrics.frames_decoded == S * n
    assert dec.metrics.plc_frames == (1 if fetch else 0)


def test_device_parse_decode_stream_chunked(stream, monkeypatch):
    """chunk_frames=2 over 5 batches: two chunks through decode_bytes_frames,
    then the last batch alone; equal to the per-batch loop."""
    batches, want, _ = stream
    chunks = []
    real = serving.decode_bytes_frames

    def spy(cfg, nbytes, state, payloads):
        chunks.append(tuple(payloads.shape))
        return real(cfg, nbytes, state, payloads)

    monkeypatch.setattr(serving, "decode_bytes_frames", spy)
    dec = BatchDecoder(CFG48, S, NBYTES, device="cpu")
    outs = dec.decode_stream(iter(batches), chunk_frames=2)
    assert chunks == [(2, S, NBYTES)] * 2
    assert len(outs) == NFRAMES
    assert all(np.array_equal(a, b) for a, b in zip(outs, want))
    assert dec.metrics.frames_decoded == S * NFRAMES


def test_chunk_closes_on_nbytes_change(goldens, monkeypatch):
    """Frame sizes 80, 150, 150, 40, 40 with chunk_frames=2: the 80 B batch
    is closed alone by the change, then two full chunks; equal to the
    per-batch loop, which follows the rate changes with its state kept."""
    cp = goldens("torch_config_parity")
    plan = [int(n) for n in cp["rate_plan_nbytes"][1:6]]
    assert plan == [80, 150, 150, 40, 40]
    batches = [cp["rate_plan_payloads"][f + 1:f + 2, :nb] for f, nb in enumerate(plan)]
    ref = BatchDecoder(CFG48, 1, plan[0], device="cpu")
    want = [ref.decode(b) for b in batches]
    chunks = []
    real = serving.decode_bytes_frames

    def spy(cfg, nbytes, state, payloads):
        chunks.append(tuple(payloads.shape))
        return real(cfg, nbytes, state, payloads)

    monkeypatch.setattr(serving, "decode_bytes_frames", spy)
    dec = BatchDecoder(CFG48, 1, plan[0], device="cpu")
    outs = dec.decode_stream(iter(batches), fetch=False, chunk_frames=2)
    assert chunks == [(2, 1, 150), (2, 1, 40)]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(outs, want))


def test_host_parse_follows_rate_changes(goldens):
    """Host-parse decode with nbytes changing per call keeps its state:
    within 1 LSB of the oracle over the whole rate plan."""
    cp = goldens("torch_config_parity")
    plan = [int(n) for n in cp["rate_plan_nbytes"]]
    pl = cp["rate_plan_payloads"]
    dec = BatchDecoder(CFG48, 1, plan[0], device="cpu", device_parse=False)
    out = np.stack([dec.decode(pl[f:f + 1, :nb])[0] for f, nb in enumerate(plan)])
    assert np.abs(out.astype(int) - cp["rate_plan_pcm_out"]).max() <= 1


def test_decode_tensor_needs_device_parse():
    dec = BatchDecoder(CFG48, S, NBYTES, device="cpu", device_parse=False)
    with pytest.raises(ValueError, match="device_parse=True"):
        dec.decode_tensor(None)
