"""lc3jax_torch frame parser (plain version) against the reference parsers.

device_parse_plain translates lc3jax/coding/device.py:device_parse; it is
held field for field against the Python parser (stream50, fuzz) and the
C++ parser (the corpus; parse is stateless, so a geometry's 200 frames go
through as one batch). On corrupt frames the parsers agree on bad_frame.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lc3jax.coding import native
from lc3jax.coding.host import parse_frames
from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.config import Lc3Config as JLc3Config
from lc3jax.ref.encoder import Lc3Encoder
from lc3jax_torch.coding import parse_kernel
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.coding.device import device_parse, device_parse_plain
from test_corpus import GEOMETRIES, _cfg

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
J48 = JLc3Config.new(48000, JFrameDuration.MS10)


def _port_cfg(cfg):
    return Lc3Config.new(cfg.fs, FrameDuration(cfg.n_ms.value))


def _assert_fields_equal(got, want, good=None):
    for f in dataclasses.fields(got):
        a = getattr(got, f.name).numpy()
        b = np.asarray(getattr(want, f.name))
        if f.name == "bad_frame" or good is None:
            assert np.array_equal(a, b.astype(a.dtype)), f.name
        else:
            assert np.array_equal(a[good], b[good].astype(a.dtype)), f.name


def test_parse_matches_python_parser_on_stream50(goldens):
    g = goldens("stream50")
    got = device_parse_plain(CFG48, 120, torch.as_tensor(g["payloads"]))
    _assert_fields_equal(got, parse_frames(J48, [bytes(r) for r in g["payloads"]]))


@pytest.mark.skipif(not native.available(), reason="native library not built")
@pytest.mark.parametrize("key", GEOMETRIES)
def test_parse_matches_native_parser_on_corpus(goldens, key):
    cfg, nbytes = _cfg(key)
    payloads = goldens("corpus")[key + "_payloads"]
    want = native.parse_frames_native(cfg, payloads)
    good = ~np.asarray(want.bad_frame)
    got = device_parse_plain(_port_cfg(cfg), nbytes, torch.as_tensor(payloads))
    _assert_fields_equal(got, want, good)


def test_parse_fuzz_matches_python_parser():
    """Random frames mixed with valid ones: every field equal on good
    frames, identical bad_frame flags everywhere."""
    nbytes = 80
    arr = np.random.default_rng(11).integers(0, 256, (24, nbytes), dtype=np.uint8)
    t = np.arange(2 * 480) / 48000
    sig = (7000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
    enc = Lc3Encoder(1, JFrameDuration.MS10, 48000)
    for f in range(2):
        arr[f] = np.frombuffer(bytes(enc.encode_frame(0, sig[f * 480:(f + 1) * 480], nbytes)),
                               np.uint8)
    want = parse_frames(J48, [bytes(r) for r in arr])
    bad = np.asarray(want.bad_frame)
    assert not bad[:2].any() and bad.mean() > 0.2
    got = device_parse_plain(CFG48, nbytes, torch.as_tensor(arr))
    _assert_fields_equal(got, want, ~bad)


def test_bad_frames_keep_side_fields_and_zero_the_rest():
    """The JAX device_parse rule on corrupt frames: x_int, nf_seed,
    ltpf_active and pitch_index are zeroed, side fields keep their values."""
    arr = np.random.default_rng(3).integers(0, 256, (64, 100), dtype=np.uint8)
    got = device_parse_plain(CFG48, 100, torch.as_tensor(arr))
    bad = got.bad_frame
    assert bool(bad.any())
    assert not bool(got.x_int[bad].any()) and not bool(got.nf_seed[bad].any())
    assert not bool(got.ltpf_active[bad].any()) and not bool(got.pitch_index[bad].any())
    assert bool(got.gg_ind[bad].any())  # side info read before the error stays


def test_device_parse_takes_plain_for_cpu(goldens):
    g = goldens("stream50")
    pl = torch.as_tensor(g["payloads"][:4])
    before = parse_kernel.launches
    got = device_parse(CFG48, 120, pl)
    assert parse_kernel.launches == before
    _assert_fields_equal(got, device_parse_plain(CFG48, 120, pl))
    with pytest.raises(ValueError, match="CUDA"):
        parse_kernel.parse_frames_cuda(CFG48, 120, pl)


def test_kernel_table_buffer_layout():
    """csrc/parse.cu reads the tables at fixed offsets."""
    from lc3jax import tables as T

    buf = parse_kernel.table_buffer()
    assert buf.shape == (parse_kernel.TABLE_WORDS,) and buf.dtype == np.int32
    assert np.array_equal(buf[2176:6272], T.AC_SPEC_LOOKUP)
    assert np.array_equal(buf[6576:].reshape(16, 11), T.MPVQ_OFFSETS)
