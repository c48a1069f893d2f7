"""lc3jax_torch.checkpoint against lc3jax.checkpoint: one file format, so a
checkpoint either package writes loads in the other (lc3jax's states are
only built here, no JAX program is compiled), and a restored state resumes
bit-exact; plus the rejection cases of tests/test_streaming_checkpoint.py."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lc3jax import checkpoint as jckpt
from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.config import Lc3Config as JLc3Config
from lc3jax.dsp import decoder as jdec
from lc3jax.dsp import encoder as jenc
from lc3jax.dsp.encoder_ltpf import LtpfEncState as JLtpfEncState
from lc3jax.dsp.ltpf import LtpfState as JLtpfState
from lc3jax_torch.checkpoint import load_state, save_state
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import decoder_state_to_numpy, encoder_state_to_numpy
from lc3jax_torch.dsp.decoder import decoder_init
from lc3jax_torch.dsp.encoder import encoder_init
from lc3jax_torch.serving import BatchDecoder, BatchEncoder

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
J48 = JLc3Config.new(48000, JFrameDuration.MS10)
S, NBYTES = 2, 120
SPLIT = {"decoder": 3, "encoder": 2}  # frames before the checkpoint, and after it


def _coder(kind):
    if kind == "decoder":
        return BatchDecoder(CFG48, S, NBYTES, device="cpu", device_parse=False)
    return BatchEncoder(CFG48, S, NBYTES, device="cpu")


def _inputs(g, kind):
    """2 * SPLIT[kind] batches of S streams: stream50's frames (decoder) or
    PCM (encoder), stream 1 one frame behind stream 0."""
    src = g["payloads"] if kind == "decoder" else g["pcm_in"]
    return [np.stack([src[f + 1], src[f]]) for f in range(2 * SPLIT[kind])]


def _step(coder, x):
    return coder.decode(x) if isinstance(coder, BatchDecoder) else coder.encode(x)


@pytest.fixture(scope="module", params=["decoder", "encoder"])
def live(request, goldens):
    """(kind, inputs, the state after the first half, the live outputs of
    the second half)."""
    kind = request.param
    xs = _inputs(goldens("stream50"), kind)
    coder = _coder(kind)
    for x in xs[: SPLIT[kind]]:
        _step(coder, x)
    state = copy.deepcopy(coder.state)  # a snapshot: the coder's own state moves on
    outs = [_step(coder, x) for x in xs[SPLIT[kind]:]]
    return kind, xs, state, outs


def _jax_state(kind, st):
    """lc3jax's DecoderState or EncoderState holding the port state's values."""
    if kind == "decoder":
        d = decoder_state_to_numpy(st)
        return jdec.DecoderState(ltpf=JLtpfState(**d.pop("ltpf")), **d)
    d = encoder_state_to_numpy(st)
    return jenc.EncoderState(ltpf=JLtpfEncState(**d.pop("ltpf")), **d)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}.{k}") if isinstance(v, dict) else {f"{prefix}.{k}": v})
    return out


def test_port_checkpoint_loads_in_lc3jax(live, tmp_path):
    kind, _, state, _ = live
    path = str(tmp_path / "state.npz")
    save_state(path, state, config_tag="48000/MS10/S=2")
    like = jdec.decoder_init(J48, S) if kind == "decoder" else jenc.encoder_init(J48, S)
    got = jckpt.load_state(path, like, config_tag="48000/MS10/S=2")
    want = _flat(decoder_state_to_numpy(state) if kind == "decoder"
                 else encoder_state_to_numpy(state))
    leaves = {jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(leaves) == sorted(want)
    for k, v in want.items():
        assert leaves[k].dtype == v.dtype and np.array_equal(leaves[k], v), k


@pytest.mark.parametrize("writer", ["lc3jax_torch", "lc3jax"])
def test_checkpoint_resumes_bitexact(live, writer, tmp_path):
    """A checkpoint of the state after the first half, written by either
    package, loads into a fresh state and gives the live run's second half."""
    kind, xs, state, outs = live
    path = str(tmp_path / "state.npz")
    if writer == "lc3jax":
        jckpt.save_state(path, _jax_state(kind, state))
    else:
        save_state(path, state)
    coder = _coder(kind)
    fresh = decoder_init(CFG48, S, "cpu") if kind == "decoder" else encoder_init(CFG48, S, "cpu")
    coder.state = load_state(path, fresh)
    assert {t.device.type for t in (vars(coder.state) | vars(coder.state.ltpf)).values()
            if isinstance(t, torch.Tensor)} == {"cpu"}
    resumed = [_step(coder, x) for x in xs[SPLIT[kind]:]]
    assert all(np.array_equal(a, b) for a, b in zip(resumed, outs))


def _bad_like(case):
    st = decoder_init(CFG48, S, "cpu")
    return {
        "shape": (decoder_init(CFG48, 4, "cpu"), {}, "shape"),
        "config": (st, {"config_tag": "48000/MS10/S=4"}, "config mismatch"),
        "field": (st.ltpf, {}, "field mismatch"),
        "encoder": (encoder_init(CFG48, S, "cpu"), {}, "field mismatch"),
        "dtype": (dataclasses.replace(st, plc_seed=st.plc_seed.long()), {}, "dtype"),
    }[case]


@pytest.mark.parametrize("case", ["shape", "config", "field", "encoder", "dtype"])
def test_checkpoint_rejects_mismatches(case, tmp_path):
    path = str(tmp_path / "state.npz")
    save_state(path, decoder_init(CFG48, S, "cpu"), config_tag="48000/MS10/S=2")
    like, kw, words = _bad_like(case)
    with pytest.raises(ValueError, match=words):
        load_state(path, like, **kw)
    # a matching tag, or none, loads
    load_state(path, decoder_init(CFG48, S, "cpu"), config_tag="48000/MS10/S=2")
    load_state(path, decoder_init(CFG48, S, "cpu"))


def test_checkpoint_rejects_a_file_without_metadata(tmp_path):
    np.savez(str(tmp_path / "old.npz"), leaf_0=np.zeros(3))
    with pytest.raises(ValueError, match="missing metadata"):
        load_state(str(tmp_path / "old.npz"), decoder_init(CFG48, S, "cpu"))
