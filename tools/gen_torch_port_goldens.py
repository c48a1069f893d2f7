#!/usr/bin/env python3
"""Writes tests/goldens/torch_port.npz: outputs of JAX programs that the
lc3jax_torch tests hold the port against, so those tests compile no JAX.

    JAX_PLATFORMS=cpu python tools/gen_torch_port_goldens.py

Contents (S streams on the leading axis of every array):

- `ltpf48_*`, `ltpf32_*`: `lc3jax.dsp.ltpf.ltpf_run(use_pallas=False)` at
  48 kHz / 10 ms and 32 kHz / 7.5 ms on the random-state stress inputs of
  tests/test_pallas_ltpf.py (S = 16, 1200 frame bits): the inputs (`in_*`,
  state leaves `st_*`), the output `y` and the new state (`out_*`).
- `dec_*`: `lc3jax.dsp.decoder.decode_step` at 32 kHz / 7.5 ms, 60 B,
  S = 4, over 6 frames of oracle-encoded content that switches the LTPF on,
  with one corrupt frame, from a random initial state: the payloads
  [T, S, nbytes], the initial state (`dec_init_*`), the PCM [T, S, nf] and
  the final state (`dec_final_*`). Frames are parsed by the host parser.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lc3jax.coding.host import parse_frames  # noqa: E402
from lc3jax.config import FrameDuration, Lc3Config  # noqa: E402
from lc3jax.dsp.decoder import DecoderState, decode_step  # noqa: E402
from lc3jax.dsp.ltpf import LtpfState, _filter_params, _gains, ltpf_run  # noqa: E402
from lc3jax.dsp.params import decoder_params  # noqa: E402
from lc3jax.ref.encoder import Lc3Encoder  # noqa: E402

F32 = np.float32


def ltpf_case(cfg, seed: int, S: int = 16) -> dict:
    p = decoder_params(cfg)
    rng = np.random.default_rng(seed)
    H = p.num_mem_blocks * p.nf
    st = dict(
        hist_x=(rng.standard_normal((S, H)) * 1000).astype(F32),
        hist_y=(rng.standard_normal((S, H)) * 1000).astype(F32),
        c_num=(rng.standard_normal((S, p.l_num + 1)) * 0.2).astype(F32),
        c_den=(rng.standard_normal((S, p.l_den + 1)) * 0.2).astype(F32),
        p_int=rng.integers(18, 855, S).astype(np.int32),
        p_fr=rng.integers(0, 4, S).astype(np.int32),
        active=rng.integers(0, 2, S).astype(bool),
    )
    x = (rng.standard_normal((S, p.nf)) * 2000).astype(F32)
    active = rng.integers(0, 2, S).astype(bool)
    pitch = rng.integers(0, 512, S).astype(np.int32)
    fn = jax.jit(lambda st, x, a, pi: ltpf_run(p, st, x, 1200, a, pi, use_pallas=False))
    y, new = fn(LtpfState(**{k: jnp.asarray(v) for k, v in st.items()}), x, active, pitch)
    out = {f"st_{k}": v for k, v in st.items()}
    out.update(in_x=x, in_active=active, in_pitch=pitch, y=np.asarray(y))
    out.update({f"out_{f.name}": np.asarray(getattr(new, f.name))
                for f in dataclasses.fields(LtpfState)})
    return out


def random_state(cfg, nbits: int, S: int, rng) -> dict:
    """A decoder state in the middle of a stream: random memories, LTPF
    coefficients of random pitches."""
    p = decoder_params(cfg)
    H = p.num_mem_blocks * p.nf
    active = rng.integers(0, 2, S).astype(bool)
    p_int, p_fr = (np.asarray(a) for a in _filter_params(p, rng.integers(0, 512, S)))
    p_int, p_fr = np.where(active, p_int, 0), np.where(active, p_fr, 0)
    gain, ind = _gains(p, nbits)
    c_num = np.where(active[:, None], F32(0.85) * F32(gain) * p.ltpf_num_tab[ind][None], 0)
    c_den = np.where(active[:, None], F32(gain) * p.ltpf_den_tab[p_fr], 0)
    return dict(
        mem_ola=(rng.standard_normal((S, cfg.nf - cfg.z)) * 300).astype(F32),
        plc_spec=(rng.standard_normal((S, cfg.ne)) * 300).astype(F32),
        plc_alpha=rng.uniform(0.5, 1.0, S).astype(F32),
        plc_seed=rng.integers(0, 1 << 16, S).astype(np.int32),
        plc_lost=rng.integers(0, 10, S).astype(np.int32),
        ltpf=dict(
            hist_x=(rng.standard_normal((S, H)) * 300).astype(F32),
            hist_y=(rng.standard_normal((S, H)) * 300).astype(F32),
            c_num=c_num.astype(F32), c_den=c_den.astype(F32),
            p_int=p_int.astype(np.int32), p_fr=p_fr.astype(np.int32), active=active,
        ),
    )


def flat(prefix: str, st: dict) -> dict:
    out = {}
    for k, v in st.items():
        if isinstance(v, dict):
            out.update(flat(f"{prefix}ltpf_", v))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def to_jax(st: dict) -> DecoderState:
    return DecoderState(
        ltpf=LtpfState(**{k: jnp.asarray(v) for k, v in st["ltpf"].items()}),
        **{k: jnp.asarray(v) for k, v in st.items() if k != "ltpf"},
    )


def from_jax(st) -> dict:
    out = {f.name: np.asarray(getattr(st, f.name))
           for f in dataclasses.fields(st) if f.name != "ltpf"}
    out["ltpf"] = {f.name: np.asarray(getattr(st.ltpf, f.name))
                   for f in dataclasses.fields(st.ltpf)}
    return out


def decode_case(T: int = 6, S: int = 4, nbytes: int = 60) -> dict:
    cfg = Lc3Config.new(32000, FrameDuration.MS7P5)
    rng = np.random.default_rng(5)
    t = np.arange(T * cfg.nf) / cfg.fs
    signals = [
        (8000 * np.sin(2 * np.pi * 180 * t)).astype(np.int16),
        (5000 * np.sin(2 * np.pi * 240 * t) + 200 * rng.standard_normal(len(t))).astype(np.int16),
        (1500 * rng.standard_normal(len(t))).astype(np.int16),
        (7000 * np.sin(2 * np.pi * 130 * t)).astype(np.int16),
    ]
    payloads = np.zeros((T, S, nbytes), np.uint8)
    for s, sig in enumerate(signals):
        enc = Lc3Encoder(1, cfg.n_ms, cfg.fs)
        for f in range(T):
            frame = bytes(enc.encode_frame(0, sig[f * cfg.nf:(f + 1) * cfg.nf], nbytes))
            payloads[f, s] = np.frombuffer(frame, np.uint8)
    payloads[3, 1] = 255  # corrupt -> PLC
    init = random_state(cfg, nbytes * 8, S, rng)
    step = jax.jit(lambda st, fr: decode_step(cfg, nbytes * 8, st, fr))
    st, pcm = to_jax(init), []
    n_ltpf = 0
    for f in range(T):
        frames = parse_frames(cfg, [bytes(r) for r in payloads[f]])
        n_ltpf += int(np.asarray(frames.ltpf_active).sum())
        st, out = step(st, frames)
        pcm.append(np.asarray(out))
    assert n_ltpf > 0, "content failed to activate the LTPF"
    res = {"payloads": payloads, "pcm": np.stack(pcm)}
    res.update(flat("init_", init))
    res.update(flat("final_", from_jax(st)))
    return res


def main() -> None:
    out = {}
    for tag, cfg, seed in (("ltpf48", Lc3Config.new(48000, FrameDuration.MS10), 7),
                           ("ltpf32", Lc3Config.new(32000, FrameDuration.MS7P5), 11)):
        out.update({f"{tag}_{k}": v for k, v in ltpf_case(cfg, seed).items()})
    out.update({f"dec_{k}": v for k, v in decode_case().items()})
    path = ROOT / "tests" / "goldens" / "torch_port.npz"
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes, {len(out)} arrays)")


if __name__ == "__main__":
    main()
