"""The lc3jax_torch slice end to end on the CPU: raw frame bytes -> PCM.

Held to the JAX fused decode's own envelope against the oracle PCM stored
in the goldens (tests/test_corpus.py:94-100: <= 1 LSB, >= 100 dB SNR), on
every corpus geometry and on stream50; an exact match passes outright.
The JAX decode_bytes_step is pinned to the same PCM by
tests/test_corpus.py, so this holds the port to the JAX package without
compiling the JAX fused program again. A geometry's frames are parsed as
one batch (parse is stateless) and through the spectral stages as one
batch (stateless too); the stateful half (PLC, IMDCT, LTPF) steps frame by
frame, as decode_step does.

The JAX decode_step state after several frames is compared from the same
starting state (tests/goldens/torch_port.npz, tools/gen_torch_port_goldens.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lc3jax.coding import native
from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.config import Lc3Config as JLc3Config
from lc3jax_torch.coding.device import device_parse_plain
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import (decoder_state_from_numpy, decoder_state_to_numpy,
                                  parsed_frames_from_numpy)
from lc3jax_torch.dsp import decoder as D
from lc3jax_torch.serving import BatchDecoder
from test_corpus import GEOMETRIES, _cfg

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
CFG32 = Lc3Config.new(32000, FrameDuration.MS7P5)
J48 = JLc3Config.new(48000, JFrameDuration.MS10)


def _frame(frames, f):
    return type(frames)(**{k.name: getattr(frames, k.name)[f:f + 1]
                           for k in dataclasses.fields(frames)})


def _assert_envelope(pcm, want, name):
    err = pcm.astype(np.int64) - want.astype(np.int64)
    max_lsb = int(np.abs(err).max())
    assert max_lsb <= 1, f"{name}: max LSB {max_lsb}"
    if max_lsb:
        sig = float(np.sum(want.astype(np.float64) ** 2))
        snr = 10.0 * np.log10(sig / float(np.sum(err.astype(np.float64) ** 2)))
        assert snr >= 100.0, f"{name}: SNR {snr:.1f} dB"


def _decode_stream(cfg, nbytes, payloads):
    """One stream's frames [T, nbytes] -> PCM [T, nf]."""
    nbits = nbytes * 8
    frames = device_parse_plain(cfg, nbytes, torch.as_tensor(payloads))
    x = D.decode_spectrum(cfg, nbits, frames)
    st = D.decoder_init(cfg, 1, device="cpu")
    out = []
    for f in range(payloads.shape[0]):
        st, pcm = D.decode_synthesis(cfg, nbits, st, x[f:f + 1], _frame(frames, f))
        out.append(pcm[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("key", GEOMETRIES + ["stream50"])
def test_slice_within_jax_envelope(goldens, key):
    if key == "stream50":
        g = goldens("stream50")
        cfg, nbytes, payloads, want = CFG48, int(g["nbytes"]), g["payloads"], g["pcm_out"]
    else:
        g = goldens("corpus")
        jcfg, nbytes = _cfg(key)
        cfg = Lc3Config.new(jcfg.fs, FrameDuration(jcfg.n_ms.value))
        payloads, want = g[key + "_payloads"], g[key + "_pcm_out"]
    _assert_envelope(_decode_stream(cfg, nbytes, payloads), want, key)


def test_batch_decoder_stream50(goldens):
    """The entry point, frame by frame, over the first 12 frames."""
    g = goldens("stream50")
    dec = BatchDecoder(CFG48, 1, 120, device="cpu")
    pcm = np.stack([dec.decode(g["payloads"][f:f + 1])[0] for f in range(12)])
    _assert_envelope(pcm, g["pcm_out"][:12], "stream50")
    snap = dec.metrics.snapshot()
    assert snap["frames_decoded"] == 12 and snap["plc_frames"] == 0


def test_batch_decoder_state_matches_jax(goldens):
    """S = 4 at 32 kHz / 7.5 ms with the LTPF on and one corrupt frame, from
    a random mid-stream state: PCM within 1 LSB of JAX decode_step; PLC and
    LTPF control state equal; float memories within the f32 noise of the
    IMDCT and LTPF orderings: measured at most 9.1e-7 of each array's
    largest magnitude (hist_x: 0.0073 at 8017), bound 1e-5."""
    g = goldens("torch_port")

    def nested(prefix):
        d = {k[len(prefix):]: g[k] for k in g.files
             if k.startswith(prefix) and not k.startswith(prefix + "ltpf_")}
        d["ltpf"] = {k[len(prefix) + 5:]: g[k] for k in g.files if k.startswith(prefix + "ltpf_")}
        return d

    payloads, want_pcm = g["dec_payloads"], g["dec_pcm"]
    T, S, nbytes = payloads.shape
    dec = BatchDecoder(CFG32, S, nbytes, device="cpu")
    dec.state = decoder_state_from_numpy(nested("dec_init_"))
    pcm = np.stack([dec.decode(payloads[f]) for f in range(T)])
    assert np.abs(pcm.astype(int) - want_pcm).max() <= 1
    assert dec.metrics.plc_frames == 1
    got, want = decoder_state_to_numpy(dec.state), nested("dec_final_")
    assert want["ltpf"]["active"].any()
    for k in ("plc_alpha", "plc_seed", "plc_lost"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("c_num", "c_den", "p_int", "p_fr", "active"):
        assert np.array_equal(got["ltpf"][k], want["ltpf"][k]), k
    for name, a, b in (("mem_ola", got["mem_ola"], want["mem_ola"]),
                       ("plc_spec", got["plc_spec"], want["plc_spec"]),
                       ("hist_x", got["ltpf"]["hist_x"], want["ltpf"]["hist_x"]),
                       ("hist_y", got["ltpf"]["hist_y"], want["ltpf"]["hist_y"])):
        tol = 1e-5 * float(np.abs(b).max())
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(), tol)


def test_decoder_state_numpy_roundtrip():
    st = D.decoder_init(CFG32, 3, device="cpu")
    st.plc_seed += 7
    st.ltpf.active[1] = True
    d = decoder_state_to_numpy(st)
    back = decoder_state_to_numpy(decoder_state_from_numpy(d))
    assert d.keys() == back.keys()
    for k in d:
        items = d[k].items() if k == "ltpf" else [(k, d[k])]
        for name, v in items:
            w = back["ltpf"][name] if k == "ltpf" else back[name]
            assert v.dtype == w.dtype and np.array_equal(v, w), name


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_decode_from_native_fields_equals_fused(goldens):
    """decode_step on host-parsed fields (parsed_frames_from_numpy) gives
    the fused path's PCM: the two parsers agree, so must the decodes."""
    g = goldens("stream50")
    pl = g["payloads"][:4]
    fused = D.decode_step(CFG48, 960, D.decoder_init(CFG48, 4, device="cpu"),
                          device_parse_plain(CFG48, 120, torch.as_tensor(pl)))[1]
    host = D.decode_step(CFG48, 960, D.decoder_init(CFG48, 4, device="cpu"),
                         parsed_frames_from_numpy(native.parse_frames_native(J48, pl)))[1]
    assert torch.equal(fused, host)
