"""The lc3jax_torch encode slice on the CPU: int16 PCM -> fields -> bytes.

Held to the bar of the JAX CPU path (tests/test_corpus.py:46): every frame
byte-exact against the oracle. BatchEncoder(device="cpu") runs the port's
encode_step and its own host packer, on the first 24 frames of the six
corpus geometries and of stream50 (the full corpus runs on the card, in
chip_smoke.py), and across a change of nbytes against the oracle encoder
run with the same plan.

The JAX encode_step is compared from one mid-stream state, carried across
with encoder_state_from_numpy (tests/goldens/torch_encode.npz,
tools/gen_torch_encode_goldens.py): every field equal over three frames,
at 48 kHz / 10 ms / 150 B and 32 kHz / 7.5 ms / 60 B, and the state after
them equal or, for its float memories, within the bound stated there.
"""

import numpy as np
import pytest
import torch

from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.ref.encoder import Lc3Encoder
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import (encoder_fields_to_numpy, encoder_state_from_numpy,
                                  encoder_state_to_numpy, encoder_tables)
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.serving import BatchEncoder
from test_corpus import GEOMETRIES

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
CFG32 = Lc3Config.new(32000, FrameDuration.MS7P5)
PREFIX = 24


def _geometry(key):
    fs, dur, nb = key.split("_")
    return Lc3Config.new(int(fs), FrameDuration.MS7P5 if dur == "7.5ms"
                         else FrameDuration.MS10), int(nb)


def _encode_stream(cfg, nbytes, pcm):
    """One stream's PCM [T, nf] -> frames [T, nbytes] through BatchEncoder."""
    enc = BatchEncoder(cfg, 1, nbytes, device="cpu")
    out = np.stack([enc.encode(pcm[f:f + 1])[0] for f in range(pcm.shape[0])])
    assert enc.metrics.snapshot()["frames_encoded"] == pcm.shape[0]
    return out


@pytest.mark.parametrize("key", GEOMETRIES + ["stream50"])
def test_batch_encoder_byte_exact_on_corpus_prefix(goldens, key):
    if key == "stream50":
        g = goldens("stream50")
        cfg, nbytes, pcm, want = CFG48, int(g["nbytes"]), g["pcm_in"], g["payloads"]
    else:
        g = goldens("corpus")
        cfg, nbytes = _geometry(key)
        pcm, want = g[key + "_pcm_in"], g[key + "_payloads"]
    got = _encode_stream(cfg, nbytes, pcm[:PREFIX])
    bad = np.flatnonzero((got != want[:PREFIX]).any(1))
    assert bad.size == 0, f"{key}: frames {bad.tolist()} differ from the oracle's"


def _nested(g, prefix):
    d = {k[len(prefix):]: g[k] for k in g.files
         if k.startswith(prefix) and not k.startswith(prefix + "ltpf_")}
    d["ltpf"] = {k[len(prefix) + 5:]: g[k] for k in g.files if k.startswith(prefix + "ltpf_")}
    return d


@pytest.mark.parametrize("tag,cfg,nbytes", [("step48", CFG48, 150), ("step32", CFG32, 60)])
def test_encode_step_fields_equal_jax(goldens, tag, cfg, nbytes):
    g = goldens("torch_encode")
    init = _nested(g, f"{tag}_init_")
    st = encoder_state_from_numpy(init)
    pcm = g[f"{tag}_pcm"]
    for t in range(pcm.shape[0]):
        st, fields = E.encode_step(cfg, nbytes, st, torch.as_tensor(pcm[t]))
        got = encoder_fields_to_numpy(fields)
        want = {k[len(f"{tag}_f{t}_"):]: g[k] for k in g.files if k.startswith(f"{tag}_f{t}_")}
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(np.asarray(got[k]), v), (t, k)
    # the state: integer leaves, the PCM history and the pitch memory equal;
    # the other float leaves (energies, resampler and high-pass memories,
    # correlations) within 2e-4 of each array's largest magnitude, the f32
    # noise of the XLA orderings the port does not follow (measured at most
    # 9.4e-5, on the 12.8 kHz resampler memory)
    final, want = encoder_state_to_numpy(st), _nested(g, f"{tag}_final_")
    flat = lambda d: {**{k: v for k, v in d.items() if k != "ltpf"},  # noqa: E731
                      **{f"ltpf_{k}": v for k, v in d["ltpf"].items()}}
    final, want = flat(final), flat(want)
    assert final.keys() == want.keys()
    for k, b in want.items():
        a = final[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype != np.float32 or k in ("time_buf", "ltpf_x_ext", "ltpf_mem_pitch"):
            assert np.array_equal(a, b), k
        else:
            assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max(), k


def test_batch_encoder_keeps_state_across_nbytes_changes(goldens):
    """Two streams, a bitrate plan over 8 frames: each frame equals the
    oracle encoder's, run over the same plan from its own fresh state."""
    pcm = goldens("stream50")["pcm_in"][:16].reshape(2, 8, CFG48.nf).transpose(1, 0, 2)
    plan = [150, 150, 60, 60, 120, 40, 150, 100]
    oracle = Lc3Encoder(2, JFrameDuration.MS10, 48000)
    enc = BatchEncoder(CFG48, 2, 150, device="cpu")
    for f, nb in enumerate(plan):
        got = enc.encode(pcm[f], nbytes=nb)
        assert got.shape == (2, nb)
        for s in range(2):
            want = np.frombuffer(bytes(oracle.encode_frame(s, pcm[f, s], nb)), np.uint8)
            assert np.array_equal(got[s], want), (f, s, nb)


def test_encoder_state_numpy_roundtrip():
    st = E.encoder_init(CFG32, 3, device="cpu")
    st.att_pos_last += 2
    st.ltpf.mem_active[1] = True
    d = encoder_state_to_numpy(st)
    back = encoder_state_to_numpy(encoder_state_from_numpy(d))
    assert d.keys() == back.keys()
    for k in d:
        items = d[k].items() if k == "ltpf" else [(k, d[k])]
        for name, v in items:
            w = back["ltpf"][name] if k == "ltpf" else back[name]
            assert v.dtype == w.dtype and np.array_equal(v, w), name


def test_encoder_tables_are_cached_per_config_and_bits():
    a = encoder_tables(CFG48, 1200)
    assert encoder_tables(CFG48, 1200, "cpu") is a
    assert encoder_tables(CFG48, 480) is not a
    assert encoder_tables(CFG32, 1200).p is not a.p


def test_batch_encoder_rejects_wrong_shape():
    enc = BatchEncoder(CFG48, 2, 150, device="cpu")
    with pytest.raises(ValueError, match="expected PCM"):
        enc.encode(np.zeros((3, CFG48.nf), np.int16))
