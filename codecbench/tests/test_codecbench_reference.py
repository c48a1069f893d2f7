"""The benchmark's frozen reference against the repository's goldens, and
the exactness of its whole-stream runs."""

from pathlib import Path

import numpy as np
import pytest

from codecbench import reference, spec
from codecbench.ref.config import FrameDuration
from codecbench.ref.decoder import Lc3Decoder
from codecbench.ref.encoder import Lc3Encoder

GOLDENS = Path(__file__).resolve().parents[2] / "tests" / "goldens"


def test_stream50_bytes_and_pcm():
    g = np.load(GOLDENS / "stream50.npz")
    enc = Lc3Encoder(1, FrameDuration.MS10, 48000)
    dec = Lc3Decoder(1, FrameDuration.MS10, 48000)
    for f in range(20):
        frame = enc.encode_frame(0, g["pcm_in"][f], int(g["nbytes"]))
        assert frame == g["payloads"][f].tobytes()
        assert np.array_equal(dec.decode_frame(16, 0, frame), g["pcm_out"][f])


@pytest.mark.parametrize("key", ["16000_10ms_60", "48000_10ms_120", "8000_10ms_40"])
def test_corpus_golden_bytes_and_pcm(key):
    g = np.load(GOLDENS / "corpus.npz")
    fs, _, nb = key.split("_")
    enc = Lc3Encoder(1, FrameDuration.MS10, int(fs))
    dec = Lc3Decoder(1, FrameDuration.MS10, int(fs))
    for f in range(24):
        frame = enc.encode_frame(0, g[key + "_pcm_in"][f], int(nb))
        assert frame == g[key + "_payloads"][f].tobytes()
        assert np.array_equal(dec.decode_frame(16, 0, frame), g[key + "_pcm_out"][f])


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.005859375, 1.0 + 2 ** -7, -3.0e-3], np.float32)
    got = reference.bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0  # 1 + 2^-8 ties to even: 1
    assert got[2] == np.float32(1.0078125)  # above the tie: up
    assert got[3] == np.float32(1.0078125)  # exact in bfloat16
    assert np.all(got.view(np.uint32) & 0xFFFF == 0)


def test_digest_sees_every_attribute_but_the_skipped():
    a, b = Lc3Decoder(1, FrameDuration.MS10, 16000), Lc3Decoder(1, FrameDuration.MS10, 16000)
    ca, cb = a.channels[0], b.channels[0]
    assert reference.digest(ca) == reference.digest(cb)
    cb.plc.plc_seed += 1
    assert reference.digest(ca) != reference.digest(cb)
    assert reference.digest(ca, reference.SEED) == reference.digest(cb, reference.SEED)
    cb.imdct.__dict__[next(iter(vars(cb.imdct)))] = None
    assert reference.digest(ca, reference.SEED) != reference.digest(cb, reference.SEED)


@pytest.mark.parametrize("offset", [0, 150])
def test_whole_stream_run_equals_a_plain_loop(offset):
    """The shortcuts (a repeated state; a state repeated but for the PLC seed,
    up to the next concealed frame) give what decoding every frame gives,
    on the 16_2 clip whose frame 76 the reference conceals."""
    cfg = spec.config("bap16_2.s2048")
    with np.load(spec.HERE / "corpus" / "16000_10ms_40.npz") as z:
        clip, concealed = z["frames"][1], z["concealed"][1]
    assert concealed.sum() == 1
    n = 650
    got, computed = reference.run_stream({"direction": "decode", "cfg": cfg, "clip": clip,
                                          "offset": offset, "n": n, "control": False})
    dec = Lc3Decoder(1, FrameDuration.MS10, 16000)
    want = np.stack([dec.decode_frame(16, 0, clip[(offset + b) % 200].tobytes())
                     for b in range(n)])
    assert np.array_equal(got, want)
    assert computed < n - 150  # the shortcuts ran


def test_whole_stream_encode_equals_a_plain_loop():
    cfg = spec.config("bap16_2.s2048")
    from codecbench import content

    clip, _ = content.clip_pool(7, 1, 20, 160, 16000)
    got, _ = reference.run_stream({"direction": "encode", "cfg": cfg, "clip": clip[0],
                                   "offset": 3, "n": 45, "control": False})
    enc = Lc3Encoder(1, FrameDuration.MS10, 16000)
    want = np.stack([np.frombuffer(enc.encode_frame(0, clip[0][(3 + b) % 20], 40), np.uint8)
                     for b in range(45)])
    assert np.array_equal(got, want)
