"""lc3jax_torch's binding of the C++ parser (coding/host_parse.py) against
lc3jax's (coding/native.py:parse_frames_native) and against the port's
own plain parser, on encoded frames mixed with random bytes and with
encoded frames whose bytes were partly overwritten."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lc3jax.coding import native
from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.config import Lc3Config as JLc3Config
from lc3jax.ref.encoder import Lc3Encoder
from lc3jax_torch.coding import host_pack
from lc3jax_torch.coding.device import device_parse_plain
from lc3jax_torch.coding.host_parse import FIELDS, RING, HostParser
from lc3jax_torch.config import FrameDuration, Lc3Config

ROOT = Path(__file__).resolve().parent.parent
GOLD = ROOT / "tests" / "goldens"
GEOMETRIES = [(48000, "10ms", 80), (16000, "10ms", 60), (8000, "7.5ms", 30)]
N = 8  # frames of each kind


def _encoded(fs: int, dur: str, nbytes: int) -> np.ndarray:
    """N oracle frames at the geometry: stored ones where a golden has them."""
    if (fs, dur, nbytes) == (16000, "10ms", 60):
        return np.load(GOLD / "corpus.npz")["16000_10ms_60_payloads"][:N]
    if (fs, dur, nbytes) == (8000, "7.5ms", 30):
        return np.load(GOLD / "torch_config_parity.npz")["8000_7.5ms_30_payloads"][:N]
    pcm = np.load(GOLD / "stream50.npz")["pcm_in"]
    enc = Lc3Encoder(1, JFrameDuration.MS10, 48000)
    return np.stack([np.frombuffer(bytes(enc.encode_frame(0, pcm[f], nbytes)), np.uint8)
                     for f in range(N)])


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda g: f"{g[0]}_{g[1]}_{g[2]}")
def batch(request):
    """(port cfg, JAX cfg, payloads [3N, nbytes]): N encoded frames, N random
    byte strings, and the N encoded frames with 3 random bytes each
    overwritten."""
    fs, dur, nbytes = request.param
    ms = FrameDuration.MS7P5 if dur == "7.5ms" else FrameDuration.MS10
    rng = np.random.default_rng(fs + nbytes)
    enc = _encoded(fs, dur, nbytes)
    hit = enc.copy()
    for row in hit:
        row[rng.integers(0, nbytes, 3)] = rng.integers(0, 256, 3)
    payloads = np.concatenate([enc, rng.integers(0, 256, (N, nbytes), dtype=np.uint8), hit])
    return Lc3Config.new(fs, ms), JLc3Config.new(fs, JFrameDuration(ms.value)), payloads


def test_host_parser_equals_lc3jax_binding(batch):
    """Field for field, bad frames' zeroed rows included, dtype for dtype."""
    cfg, jcfg, payloads = batch
    got = HostParser(cfg).parse(payloads)
    want = native.parse_frames_native(jcfg, payloads)
    assert list(got) == [name for name, _, _ in FIELDS]
    for name, a in got.items():
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    bad = got["bad_frame"]
    assert 0 < bad.sum() < len(bad) and not bad[:N].any()
    for name, a in got.items():  # the C++ contract: a bad frame's row is all zero
        if name != "bad_frame":
            assert not a[bad].any(), name


def test_host_parser_equals_plain_parser_on_good_frames(batch):
    """bad_frame equal on every frame, every field equal on the good ones."""
    cfg, _, payloads = batch
    got = HostParser(cfg).parse(payloads)
    want = device_parse_plain(cfg, payloads.shape[1], torch.as_tensor(payloads))
    good = ~got["bad_frame"]
    for name, a in got.items():
        b = getattr(want, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a[good] if name != "bad_frame" else a,
                              b[good] if name != "bad_frame" else b), name


def test_bad_frame_contracts_differ():
    """The port's plain parser keeps the side fields it read before the
    error on a bad frame (as lc3jax's device_parse does); the C++ parser
    zeroes them. PLC reads neither, so both contracts stay."""
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    g = np.load(GOLD / "stream50.npz")["payloads"][:16].copy()
    g[:, 40:60] = 0xA5  # the side info (at the tail) intact, the spectrum broken
    host = HostParser(cfg).parse(g)
    plain = device_parse_plain(cfg, g.shape[1], torch.as_tensor(g))
    bad = host["bad_frame"]
    assert bad.any() and np.array_equal(bad, plain.bad_frame.numpy())
    assert not host["gg_ind"][bad].any()
    assert plain.gg_ind.numpy()[bad].any()


def test_ring_result_survives_three_calls():
    """A result stays valid through RING - 1 = 3 more parses of the same
    batch size; the next one reuses its buffers."""
    assert RING == 4
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    pl = np.load(GOLD / "stream50.npz")["payloads"]
    parser = HostParser(cfg)
    first = parser.parse(pl[0:2])
    kept = {k: v.copy() for k, v in first.items()}
    later = [parser.parse(pl[2 * i:2 * i + 2]) for i in range(1, RING)]
    assert all(np.array_equal(first[k], kept[k]) for k in kept)
    assert not np.array_equal(later[0]["x_int"], kept["x_int"])
    reused = parser.parse(pl[10:12])
    assert np.shares_memory(reused["x_int"], first["x_int"])
    other = HostParser(cfg).parse(pl[12:14])  # each parser owns its ring
    assert not np.shares_memory(other["x_int"], first["x_int"])


def test_upload_outlives_the_ring():
    """upload() turns the latest parse into ParsedFrames of their own (a
    clone on the CPU), equal to the parsed fields after the ring has come
    round."""
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    pl = np.load(GOLD / "stream50.npz")["payloads"]
    parser = HostParser(cfg, "cpu")
    kept = {k: v.copy() for k, v in parser.parse(pl[0:2]).items()}
    frames = parser.upload()
    for i in range(1, RING + 1):
        parser.parse(pl[2 * i:2 * i + 2])
    for name, want in kept.items():
        got = getattr(frames, name)
        assert got.dtype == (torch.bool if want.dtype == bool else torch.int32), name
        assert np.array_equal(got.numpy(), want), name


_C_ENTRY = re.compile(r"^(void|int) (lc3_\w+)\((.*?)\)\s*\{", re.S | re.M)
_C_TYPES = {"int": "int", "const uint8_t*": "uint8", "uint8_t*": "uint8",
            "const int16_t*": "int16", "int32_t*": "int32", "const int32_t*": "int32"}


def test_signatures_match_the_source():
    """Each ctypes declaration in host_pack.SIGNATURES has the arguments of
    its extern "C" definition in native/lc3_bitstream.cc, kind for kind
    (int, or a pointer of the element type), and the same return type."""
    src = (ROOT / "native" / "lc3_bitstream.cc").read_text()
    src = src[src.index('extern "C" {'):]
    found = {name: (ret, args) for ret, name, args in _C_ENTRY.findall(src)}
    assert set(found) == set(host_pack.SIGNATURES), set(found) ^ set(host_pack.SIGNATURES)
    for name, (argtypes, restype) in host_pack.SIGNATURES.items():
        ret, args = found[name]
        kinds = [_C_TYPES[" ".join(a.split()[:-1])] for a in args.split(",")]
        declared = ["int" if t is host_pack._INT else np.dtype(t._dtype_).name for t in argtypes]
        assert declared == kinds, name
        assert (restype is None) == (ret == "void"), name
