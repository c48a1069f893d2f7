"""lc3jax_torch frame parser (plain version) against the reference parsers.

device_parse_plain translates lc3jax/coding/device.py:device_parse; it is
held field for field against the Python parser (stream50, fuzz) and the
C++ parser (the corpus; parse is stateless, so a geometry's 200 frames go
through as one batch). On corrupt frames the parsers agree on bad_frame.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lc3jax.coding import native
from lc3jax.coding.host import parse_frames
from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.config import Lc3Config as JLc3Config
from lc3jax.ref.encoder import Lc3Encoder
from lc3jax_torch import _build
from lc3jax_torch.coding import parse_kernel
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.coding.device import device_parse, device_parse_plain
from test_corpus import GEOMETRIES, _cfg

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
ROOT = Path(__file__).resolve().parent.parent
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
    before = _build.launches.copy()
    got = device_parse(CFG48, 120, pl)
    assert _build.launches == before
    _assert_fields_equal(got, device_parse_plain(CFG48, 120, pl))
    with pytest.raises(ValueError, match="CUDA"):
        parse_kernel.parse_frames_cuda(CFG48, 120, pl)


def test_kernel_table_buffer_layout():
    """csrc/parse.cu reads its tables from one byte image at fixed offsets:
    each part, viewed at its narrow type, is the JAX package's table."""
    from lc3jax import tables as T

    img = parse_kernel.table_image()
    assert img.shape == (parse_kernel.TABLE_BYTES,) and img.dtype == np.uint8
    assert np.array_equal(img[:4096], T.AC_SPEC_LOOKUP)
    assert np.array_equal(img[6432:].view(np.int32).reshape(16, 11), T.MPVQ_OFFSETS)


def _image_part(name):
    img = parse_kernel.table_image()
    parts = {n: (dtype, off) for n, _, dtype, off in parse_kernel.TABLE_LAYOUT}
    offs = sorted(off for _, off in parts.values()) + [parse_kernel.TABLE_BYTES]
    dtype, off = parts[name]
    return img[off : offs[offs.index(off) + 1]].view(dtype).astype(np.int64)


@pytest.mark.parametrize("name, cum, freq, rows", [
    ("spec_cum", "AC_SPEC_CUMFREQ", "AC_SPEC_FREQ", 64),
    ("coef_cum", "AC_TNS_COEF_CUMFREQ", "AC_TNS_COEF_FREQ", 8),
    ("order_cum", "AC_TNS_ORDER_CUMFREQ", "AC_TNS_ORDER_FREQ", 2),
])
def test_narrowed_tables_equal_their_sources(name, cum, freq, rows):
    """The u16 rows of the image are the int32 cumulative frequencies without
    their leading 0, and the frequencies the kernel derives from them (the
    next entry less its own, 1024 past the last) are the int32 freq table."""
    from lc3jax import tables as T

    c = np.asarray(getattr(T, cum), np.int64)
    f = np.asarray(getattr(T, freq), np.int64)
    K = c.shape[1]
    part = _image_part(name).reshape(rows, -1)
    assert np.all(c[:, 0] == 0)
    assert np.array_equal(part[:, : K - 1], c[:, 1:])
    assert not part[:, K - 1 :].any()  # the order rows' pad
    nxt = np.concatenate([part[:, : K - 1], np.full((rows, 1), 1024)], 1)
    assert np.array_equal(nxt - np.concatenate([np.zeros((rows, 1), np.int64),
                                                part[:, : K - 1]], 1), f)
    assert np.array_equal(_image_part("lookup"), T.AC_SPEC_LOOKUP)


def _camel(names):
    return [re.sub(r"(?<!^)([A-Z])", r"_\1", n[1:]).lower() for n in names]


def test_kernel_layout_constants_match_the_sources():
    """The byte offsets (k* constants) and the [S] row orders (enum I32Row,
    U8Row) of csrc/parse.cu equal parse_kernel.py's."""
    src = (ROOT / "lc3jax_torch" / "csrc" / "parse.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    for name, _, _, off in parse_kernel.TABLE_LAYOUT:
        key = "k" + "".join(w.capitalize() for w in name.split("_"))
        assert const[key] == off, (name, const[key], off)
    assert const["kTableBytes"] == parse_kernel.TABLE_BYTES
    for enum, rows in (("I32Row", parse_kernel.I32_ROWS), ("U8Row", parse_kernel.U8_ROWS)):
        body = re.search(rf"enum {enum} \{{([^}}]*)\}}", src).group(1)
        names = [n.strip() for n in body.split(",") if n.strip()]
        assert _camel(names[:-1]) == list(rows), (enum, names)


@pytest.mark.parametrize("S, ne", [(1, 400), (3, 80), (2047, 400), (5, 60)])
def test_output_views_are_fields_of_two_pools(S, ne):
    """output_views hands out each ParsedFrames field as a C-contiguous view
    of the int32 or the uint8 pool, at the field's shape and type (bool as
    a view of the uint8 pool), no two overlapping and together covering
    both pools."""
    from lc3jax_torch.dsp.decoder import BOOL_FRAME_FIELDS

    n32, n8 = parse_kernel.pool_sizes(S, ne)
    pool32 = torch.empty(n32, dtype=torch.int32)
    pool8 = torch.empty(n8, dtype=torch.uint8)
    views = parse_kernel.output_views(pool32, pool8, S, ne)
    wide = {"x_int": (S, ne), "residual_bits": (S, ne), "rc_order": (S, 2), "rc_i": (S, 16),
            "sns_y": (S, 16)}
    spans = {32: [], 8: []}
    for f in dataclasses.fields(views):
        v = getattr(views, f.name)
        assert tuple(v.shape) == wide.get(f.name, (S,)), f.name
        assert v.dtype == (torch.bool if f.name in BOOL_FRAME_FIELDS else torch.int32), f.name
        assert v.is_contiguous(), f.name
        pool = pool8 if v.dtype == torch.bool else pool32
        assert v.untyped_storage().data_ptr() == pool.untyped_storage().data_ptr(), f.name
        start = v.data_ptr() - pool.data_ptr()
        spans[8 if v.dtype == torch.bool else 32].append((start, start + v.nbytes, f.name))
    for bits, pool in ((32, pool32), (8, pool8)):
        s = sorted(spans[bits])
        assert s[0][0] == 0 and s[-1][1] == pool.nbytes, s
        assert all(a[1] == b[0] for a, b in zip(s, s[1:])), s  # abutting: no overlap, no gap
    # the int32 rows sit where the kernel writes them
    assert views.x_int.data_ptr() == pool32.data_ptr()
    assert views.residual_bits.data_ptr() == pool8.data_ptr()
    for r, name in enumerate(parse_kernel.I32_ROWS):
        assert getattr(views, name).data_ptr() == pool32.data_ptr() + 4 * (S * (ne + 34) + r * S)
    for r, name in enumerate(parse_kernel.U8_ROWS):
        assert getattr(views, name).data_ptr() == pool8.data_ptr() + S * ne + r * S
