"""lc3jax_torch.api on the CPU: the buffer calculators and ALL_CONFIGS
against lc3jax's (numpy and lc3jax.ref only: no JAX program runs), the
Lc3Encoder / Lc3Decoder facade against the oracle's stored output
(tests/goldens/stream50.npz and torch_api.npz, from
tools/gen_torch_api_goldens.py), and the zero-byte frame, which the
device-parse decode conceals as lc3jax does. The card runs the same
checks in chip_smoke.py phase 12."""

import numpy as np
import pytest
import torch

import lc3jax.api as jax_api
from lc3jax import config as jax_config
from lc3jax_torch import api
from lc3jax_torch.coding.device import device_parse_plain
from lc3jax_torch.coding.host_parse import HostParser
from lc3jax_torch.config import ALL_CONFIGS, FrameDuration, Lc3Config, SamplingFrequency
from lc3jax_torch.serving import BatchDecoder

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
CALCS = ("decoder_calc_working_buffer_lengths", "decoder_ram_bytes",
         "encoder_calc_working_buffer_lengths")


def _jax_config(cfg):
    return jax_config.FrameDuration[cfg.n_ms.name], cfg.fs


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("index", range(len(jax_config.ALL_CONFIGS)))
def test_calculators_equal_lc3jax(index, channels):
    """Each calculator, at every config of ALL_CONFIGS and 1-2 channels,
    gives lc3jax's result, given the frequency as an int or an enum."""
    cfg = ALL_CONFIGS[index]
    jd, fs = _jax_config(cfg)
    for name in CALCS:
        want = getattr(jax_api, name)(channels, jd, fs)
        assert getattr(api, name)(channels, cfg.n_ms, fs) == want, name
        assert getattr(api, name)(channels, cfg.n_ms, SamplingFrequency(fs)) == want, name


def test_decoder_ram_bytes_is_the_published_figure():
    """27,564 bytes at 48 kHz / 10 ms, one channel (reference README.md:130),
    and the calculators' other values there."""
    assert api.decoder_ram_bytes(1, FrameDuration.MS10, 48000) == 27564
    assert api.decoder_calc_working_buffer_lengths(1, FrameDuration.MS10, 48000) == (4971, 960)
    assert api.encoder_calc_working_buffer_lengths(1, FrameDuration.MS10, 48000) == (
        1900, 1106, 960)


def test_all_configs_equal_lc3jax():
    """The port's ALL_CONFIGS is lc3jax's, in order, field for field; the
    package and api export lc3jax's names."""
    import lc3jax
    import lc3jax_torch

    assert len(ALL_CONFIGS) == len(jax_config.ALL_CONFIGS) == 12
    for ours, theirs in zip(ALL_CONFIGS, jax_config.ALL_CONFIGS):
        assert (ours.fs_ind, ours.fs, ours.ne, ours.n_ms.name, ours.nb, ours.nf, ours.z) == (
            theirs.fs_ind, theirs.fs, theirs.ne, theirs.n_ms.name, theirs.nb, theirs.nf,
            theirs.z)
    assert lc3jax_torch.__all__ == lc3jax.__all__
    assert api.__all__ == jax_api.__all__
    assert lc3jax_torch.SamplingFrequency is api.SamplingFrequency is SamplingFrequency


def _lossy(goldens):
    g = goldens("torch_api")
    return [bytes(p[:n]) for p, n in zip(g["lossy_payloads"], g["lossy_nbytes"])], g


FRAMES = 12  # of stream50's 50 on the CPU (chip_smoke.py phase 12 runs all 50)


def test_facade_on_stream50(goldens):
    """Two channels called interleaved over stream50's first FRAMES
    frames: channel 0 encodes them to the oracle's frames and decodes those
    within 1 LSB and at >= 100 dB of its PCM; channel 1 decodes them with
    a corrupt, a truncated and an empty frame within 1 LSB of the oracle,
    those three concealed."""
    g = goldens("stream50")
    frames1, lossy = _lossy(goldens)
    enc = api.Lc3Encoder(2, FrameDuration.MS10, 48000, device="cpu")
    dec = api.Lc3Decoder(2, FrameDuration.MS10, 48000, device="cpu")
    assert enc.config == dec.config == CFG48
    pcm0, pcm1 = [], []
    for f in range(FRAMES):
        out = enc.encode_frame(0, g["pcm_in"][f], 120)
        assert isinstance(out, bytes) and out == g["payloads"][f].tobytes(), f
        pcm0.append(dec.decode_frame(16, 0, out))
        pcm1.append(dec.decode_frame(16, 1, frames1[f]))
    pcm0, pcm1 = np.stack(pcm0), np.stack(pcm1)
    assert pcm0.dtype == pcm1.dtype == np.int16 and pcm0.shape == (FRAMES, 480)
    want = g["pcm_out"][:FRAMES].astype(np.int64)
    err = pcm0.astype(np.int64) - want
    assert np.abs(err).max() <= 1
    assert not err.any() or 10 * np.log10(np.sum(want ** 2) / np.sum(err ** 2)) >= 100
    assert np.abs(pcm1.astype(np.int64) - lossy["lossy_pcm_out"][:FRAMES]).max() <= 1
    assert dec.channels[1].metrics.plc_frames == int(lossy["lossy_concealed"].sum()) == 3
    assert max(lossy["lossy_positions"]) < FRAMES
    assert dec.channels[0].metrics.plc_frames == 0
    assert enc.channels[1] is None


def test_decode_frame_refuses_other_sample_widths(goldens):
    """decode_frame(24, ...) raises ValueError before it touches a channel:
    the state after it is the state before, and the next frame decodes as
    if the call had not been made."""
    g = goldens("stream50")
    dec = api.Lc3Decoder(1, FrameDuration.MS10, 48000, device="cpu")
    with pytest.raises(ValueError, match="16 bits"):
        dec.decode_frame(24, 0, g["payloads"][0].tobytes())
    assert dec.channels[0] is None
    first = dec.decode_frame(16, 0, g["payloads"][0].tobytes())
    before = [t.clone() for t in _leaves(dec.channels[0].state)]
    with pytest.raises(ValueError, match="16 bits"):
        dec.decode_frame(24, 0, g["payloads"][1].tobytes())
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(dec.channels[0].state)))
    second = dec.decode_frame(16, 0, g["payloads"][1].tobytes())
    assert np.abs(np.stack([first, second]).astype(int) - g["pcm_out"][:2]).max() <= 1


def _leaves(state):
    from lc3jax_torch.compiled import leaves

    return [t for t in leaves(state) if isinstance(t, torch.Tensor)]


def test_facade_two_channels_at_16k(goldens):
    """Two channels at 16 kHz / 10 ms, each with its own content and frame
    sizes (channel 1 changing nbytes mid-stream), called interleaved: each
    equals a mono oracle run, frames byte-exact and PCM within 1 LSB."""
    g = goldens("torch_api")
    enc = api.Lc3Encoder(2, FrameDuration.MS10, SamplingFrequency.HZ16000, device="cpu")
    dec = api.Lc3Decoder(2, FrameDuration.MS10, 16000, device="cpu")
    for f in range(g["k16_pcm_in"].shape[1]):
        for c in range(2):
            nb = int(g["k16_nbytes"][c, f])
            out = enc.encode_frame(c, g["k16_pcm_in"][c, f].tolist(), nb)  # a list, coerced
            assert len(out) == nb and out == g["k16_payloads"][c, f, :nb].tobytes(), (c, f)
            pcm = dec.decode_frame(16, c, bytearray(out))
            assert np.abs(pcm.astype(int) - g["k16_pcm_out"][c, f]).max() <= 1, (c, f)


@pytest.mark.parametrize("device_parse", [True, False], ids=["device_parse", "host_parse"])
def test_empty_frame_batch_is_concealed(goldens, device_parse):
    """A zero-byte batch (uint8 [S, 0]) between 120 B batches: the PCM of
    every stream equals the oracle's on the same stream within 1 LSB, and
    plc_frames counts the concealed frames, as the oracle conceals them."""
    frames, lossy = _lossy(goldens)
    S, T = 3, FRAMES  # the corrupt, truncated and empty frames included
    dec = BatchDecoder(CFG48, S, 120, device="cpu", device_parse=device_parse)
    for f in range(T):
        batch = np.repeat(np.frombuffer(frames[f], np.uint8)[None], S, axis=0)
        pcm = dec.decode(batch)
        assert np.abs(pcm.astype(int) - lossy["lossy_pcm_out"][f]).max() <= 1, f
    assert dec.metrics.plc_frames == S * int(lossy["lossy_concealed"][:T].sum()) == 3 * S


@pytest.mark.parametrize("nbytes", [0, 1, 2, 3])
def test_short_frames_are_bad_in_both_parsers(nbytes):
    """Frames of 0-3 bytes (random and all-0xFF) parse without error in the
    plain parser, every one bad, as in the C++ host parser; at 0 B no
    gather touches the empty axis."""
    rng = np.random.default_rng(nbytes)
    payloads = rng.integers(0, 256, (6, nbytes), dtype=np.uint8)
    payloads[0] = 255
    frames = device_parse_plain(CFG48, nbytes, torch.as_tensor(payloads))
    parser = HostParser(CFG48, "cpu")
    host = parser.parse(payloads)
    assert frames.bad_frame.all() and host["bad_frame"].all()
    assert not frames.ltpf_active.any() and not frames.x_int.any()
