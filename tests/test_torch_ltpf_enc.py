"""lc3jax_torch encoder LTPF pitch analysis: the kernel's wrapper and the
constants it hands the kernel, on the CPU; the kernel against its plain
version on the card, alone and inside a replayed encode step.

The plain version (encoder_ltpf.ltpf_analysis_plain) is held to the JAX
package and the oracle by the encoder's tests (test_torch_encoder.py and
the corpus); here the kernel is held to it bit for bit (`torch.equal` on
every field and state tensor). The tests marked `card` need a CUDA card and
skip without one; this file imports no JAX, so on a machine with a card
and without JAX it runs from the repository's root as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ltpf_enc.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lc3jax_torch import _build
from lc3jax_torch.config import ALL_CONFIGS, FrameDuration
from lc3jax_torch.convert import encoder_tables
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.dsp import ltpf_enc_kernel as K
from lc3jax_torch.dsp.encoder_ltpf import (K_MAX, K_MIN, NMEM, LtpfEncState, _consts_np,
                                           ltpf_analysis_plain, ltpf_enc_consts, ltpf_enc_init,
                                           ltpf_gain_on)

ROOT = Path(__file__).resolve().parent.parent
CFG_IDS = [f"{c.fs}-{c.n_ms.value}" for c in ALL_CONFIGS]
T_FRAMES = 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ------------------------------------------------------------------ inputs


def _tone(n, fs, f, phase, amp):
    return amp * np.sin(2 * np.pi * f / fs * n + phase)


def _pulses(n, fs, f, phase, amp):
    period = fs / f
    return amp * (np.mod(n + phase * period, period) < 1.0) - amp / period


# tones and pulse trains at the edges of the lag search: lags 17 and 114
# at 6.4 kHz, pitch_int 32, 127 and 157 at 12.8 kHz
EDGE_HZ = (6400 / 17, 6400 / 114, 12800 / 32, 12800 / 127, 12800 / 157)


def stress_pcm(cfg, S: int, T: int, seed: int) -> np.ndarray:
    """int16 [T, S, nf]: stream s plays kind s mod 16 (silence, full-scale
    noise and square, tones and pulse trains at EDGE_HZ, quiet noise, a tone
    that moves at frame T // 2), with a phase and level of its own."""
    rng = np.random.default_rng(seed)
    n = np.arange(T * cfg.nf, dtype=np.float64)
    out = np.zeros((S, T * cfg.nf))
    for s in range(S):
        kind, ph = s % 16, rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(3000, 30000)
        if kind == 1:
            out[s] = rng.standard_normal(n.size) * 40000
        elif kind == 2:
            out[s] = np.sign(_tone(n, cfg.fs, 100.0 + 7 * s, ph, 1.0)) * 32767
        elif 3 <= kind < 8:
            out[s] = _tone(n, cfg.fs, EDGE_HZ[kind - 3], ph, amp)
        elif 8 <= kind < 13:
            out[s] = _pulses(n, cfg.fs, EDGE_HZ[kind - 8], ph / (2 * np.pi), amp)
        elif kind == 13:
            out[s] = rng.standard_normal(n.size) * 30
        elif kind == 14:
            f = np.where(n < T // 2 * cfg.nf, 150.0, 157.0)
            out[s] = amp * np.sin(2 * np.pi * f / cfg.fs * n + ph)
        elif kind == 15:
            out[s] = _tone(n, cfg.fs, 220.0, ph, amp) + _tone(n, cfg.fs, 440.0, ph, amp / 3)
    pcm = np.clip(np.rint(out), -32768, 32767).astype(np.int16)
    return pcm.reshape(S, T, cfg.nf).transpose(1, 0, 2).copy()


def corpus_pcm(cfg, S: int, T: int, seed: int) -> np.ndarray:
    """int16 [T, S, nf]: the corpus clips (tests/goldens/corpus.npz) one
    after another, cut into this configuration's frames from an offset of
    each stream's own."""
    g = np.load(ROOT / "tests" / "goldens" / "corpus.npz")
    audio = np.concatenate([g[k].ravel() for k in sorted(g.files) if k.endswith("_pcm_in")])
    rng = np.random.default_rng(seed)
    start = rng.integers(0, audio.size - T * cfg.nf, S)
    rows = np.stack([audio[o : o + T * cfg.nf] for o in start])
    return rows.reshape(S, T, cfg.nf).transpose(1, 0, 2).copy()


def random_state(cfg, S: int, seed: int, device) -> LtpfEncState:
    """An LtpfEncState of random histories (8,000 rms), lags, pitches and
    memories: every branch of the hysteresis in one frame."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)
    f32 = lambda a: t(np.asarray(a, np.float32))
    zero = ltpf_enc_init(cfg, S, device)
    rows = {k: f32(rng.standard_normal(getattr(zero, k).shape) * 8000)
            for k in ("x_ext", "x12", "x64")}
    return LtpfEncState(**rows, h50_m1=f32(rng.standard_normal(S) * 100),
                        h50_m2=f32(rng.standard_normal(S) * 100),
                        t_prev=t(rng.integers(17, 115, S).astype(np.int32)),
                        mem_pitch=f32(rng.uniform(32, 228, S)), mem_active=t(rng.random(S) < 0.5),
                        mem_nc=f32(rng.uniform(0.8, 1.0, S)),
                        mem_mem_nc=f32(rng.uniform(0.8, 1.0, S)))


def _outputs(fields, st):
    return {**{f"field {k}": v for k, v in fields.items()},
            **{f"state {f.name}": getattr(st, f.name) for f in dataclasses.fields(LtpfEncState)}}


def _assert_equal(got, want, label):
    for k, a in got.items():
        b = want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (label, k, a.dtype, b.dtype)
        if not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"{label}: {k} differs in streams {bad}")


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("cfg", ALL_CONFIGS, ids=CFG_IDS)
def test_kernel_consts_are_the_plain_versions(cfg):
    """What the kernel is handed is the plain version's: the resampler's
    indices (as int32) and taps in fold order, tap-major, the lag weights, the
    interpolation and activation taps, the lengths; and the windows the
    kernel computes itself are the plain version's tables."""
    c = ltpf_enc_consts(cfg, torch.device("cpu"))
    k = K.kernel_consts(cfg, torch.device("cpu"))
    assert k.resamp_idx.dtype == torch.int32 and k.resamp_idx.is_contiguous()
    assert torch.equal(k.resamp_idx.long(), c.resamp_idx.t())
    assert k.resamp_tap.is_contiguous() and torch.equal(k.resamp_tap, c.resamp_tap.t())
    for name in ("lag_weight", "interp_r", "h_taps"):
        assert torch.equal(getattr(k, name), getattr(c, name)), name
    assert (k.len12, k.len64, k.delay, k.scale) == (c.len12, c.len64, c.delay, c.scale)
    assert k.ntaps == c.resamp_idx.shape[1] == c.resamp_tap.shape[1] == k.resamp_idx.shape[0]
    assert (k.nf, k.num, k.ms10) == (cfg.nf, c.ext_len - cfg.nf, cfg.n_ms == FrameDuration.MS10)
    # the plan's rows: taps past a row's own are zero, every index in the history
    assert int(c.resamp_idx.min()) >= 0 and int(c.resamp_idx.max()) < c.ext_len
    np_c = _consts_np(cfg)
    assert np.array_equal(np_c["ridx"], c.resamp_idx.numpy())
    # the lag windows: lag index l reads x64[K_MAX - K_MIN - l + j]
    lags = torch.arange(K_MAX + 1 - K_MIN)[:, None]
    assert torch.equal(c.lag_idx, K_MAX - K_MIN - lags + torch.arange(c.len64))
    # the kernel's geometry: one warp's rows, the reads inside the 12.8 kHz row
    l12 = ltpf_enc_init(cfg, 1).x12.shape[1]
    assert l12 == c.len12 + c.delay + NMEM and c.len12 % 32 == 0 and c.len12 <= 128
    assert NMEM - 3 + 2 * (c.len64 - 1) + 4 < l12 and NMEM + 2 + c.len12 - 1 < l12


@pytest.mark.parametrize("cfg", ALL_CONFIGS, ids=CFG_IDS)
def test_wrapper_takes_the_plain_version_on_the_cpu(cfg):
    """On CPU tensors the wrapper returns the plain version's outputs and
    launches nothing."""
    S = 5
    pcm = stress_pcm(cfg, S, 2, seed=cfg.fs)
    tab = encoder_tables(cfg, 320)
    nn = torch.tensor([False, True, False, False, True])
    st_k = st_p = ltpf_enc_init(cfg, S)
    before = _build.launches.copy()
    for f in range(2):
        x = torch.as_tensor(pcm[f])
        got, st_k = K.ltpf_analysis(cfg, tab, st_k, x, nn, 320)
        want, st_p = ltpf_analysis_plain(cfg, tab, st_p, x, nn, 320)
        _assert_equal(_outputs(got, st_k), _outputs(want, st_p), f"frame {f}")
    assert _build.launches == before


def _bad_args(case):
    cfg = ALL_CONFIGS[5]  # 48 kHz / 10 ms
    S = 3
    st = ltpf_enc_init(cfg, S)
    x = torch.zeros(S, cfg.nf, dtype=torch.int16)
    nn = torch.zeros(S, dtype=torch.bool)
    if case == "x_s float32":
        x = x.float()
    elif case == "x_s width":
        x = x[:, :-1]
    elif case == "t_prev int64":
        st = dataclasses.replace(st, t_prev=st.t_prev.long())
    elif case == "mem_active float32":
        st = dataclasses.replace(st, mem_active=st.mem_active.float())
    elif case == "x12 width":
        st = dataclasses.replace(st, x12=st.x12[:, 1:])
    elif case == "near_nyquist streams":
        nn = nn[:2]
    elif case == "mixed devices":
        x = x.to("meta")
    elif case == "meta":
        st = LtpfEncState(**{f.name: getattr(st, f.name).to("meta")
                             for f in dataclasses.fields(LtpfEncState)})
        x, nn = x.to("meta"), nn.to("meta")
    return cfg, encoder_tables(cfg, 320), st, x, nn, 320


@pytest.mark.parametrize("case", ["x_s float32", "x_s width", "t_prev int64", "mem_active float32",
                                  "x12 width", "near_nyquist streams", "mixed devices", "meta"])
def test_wrapper_refuses_bad_arguments(case):
    """Wrong dtypes, shapes and mixed devices raise on every device; a
    device that is neither the CPU nor a card raises too."""
    match = "unsupported device" if case == "meta" else "ltpf_analysis: .* must be"
    with pytest.raises(ValueError, match=match):
        K.ltpf_analysis(*_bad_args(case))


# -------------------------------------------------------------- on the card


# every configuration from a fresh state at S = 1, 37 and 2048 and bit rates
# on both sides of the gain limit; and from a random state: S = 2047 and 1
# at 48 kHz / 10 ms, 40 B (the gain on) and 150 B, S = 2048 at 16 kHz / 10
# ms / 40 B and at 44.1 kHz / 7.5 ms / 60 B
KERNEL_CASES = ([(c, (1, 37, 2048), None) for c in ALL_CONFIGS]
                + [(ALL_CONFIGS[5], (2047, 1), (40, 150)), (ALL_CONFIGS[1], (2048,), (40,)),
                   (ALL_CONFIGS[10], (2048,), (60,))])
KERNEL_IDS = CFG_IDS + ["48000-10ms-40B-150B-random-state", "16000-10ms-40B-random-state",
                        "44100-7.5ms-60B-random-state"]


@pytest.mark.card
@pytest.mark.parametrize("cfg,sizes,nbytes", KERNEL_CASES, ids=KERNEL_IDS)
def test_kernel_equals_plain_on_the_card(cfg, sizes, nbytes):
    """Over T_FRAMES consecutive frames (t_prev and the hysteresis carried),
    on corpus and stress PCM, near_nyquist on and off, from a fresh state at
    bit rates on both sides of the gain limit (nbytes None) or from a random
    state (random_state) at each of nbytes: every field and state tensor
    equal; from a fresh state, the stress inputs reach every pitch case."""
    dev = _card()
    if nbytes is None:
        limit = 560 + cfg.fs_ind * 80
        if cfg.n_ms == FrameDuration.MS7P5:
            limit = limit * 3 // 4
        rates = sorted({nb for nb in (160, limit - 8, limit + 8, 1200) if 20 * 8 <= nb <= 400 * 8})
        assert any(ltpf_gain_on(cfg, nb) for nb in rates) and not all(ltpf_gain_on(cfg, nb)
                                                                     for nb in rates)
    else:
        rates = [nb * 8 for nb in nbytes]
    cases = 0
    pitch_ints, active = set(), 0
    for S in sizes:
        for kind, make in (("corpus", corpus_pcm), ("stress", stress_pcm)):
            pcm = torch.as_tensor(make(cfg, S, T_FRAMES, seed=S + cfg.fs), device=dev)
            nns = torch.as_tensor(np.random.default_rng(S).random((T_FRAMES, S)) < 0.3, device=dev)
            for nbits in rates:
                tab = encoder_tables(cfg, nbits, dev)
                st_k = st_p = (ltpf_enc_init(cfg, S, dev) if nbytes is None
                               else random_state(cfg, S, S + nbits, dev))
                before = _build.launches["lc3t_ltpf_analysis"]
                for f in range(T_FRAMES):
                    got, st_k = K.ltpf_analysis(cfg, tab, st_k, pcm[f], nns[f], nbits)
                    want, st_p = ltpf_analysis_plain(cfg, tab, st_p, pcm[f], nns[f], nbits)
                    _assert_equal(_outputs(got, st_k), _outputs(want, st_p),
                                  f"S={S} {kind} {nbits} bits frame {f}")
                    if kind == "stress":  # mem_pitch: pitch_int + pitch_fr / 4 where present
                        pitch_ints |= set(st_p.mem_pitch[want["pitch_present"]].long().tolist())
                        active += int(want["ltpf_active"].sum())
                assert _build.launches["lc3t_ltpf_analysis"] == before + T_FRAMES
                cases += 1
    assert cases == len(sizes) * 2 * len(rates)
    if nbytes is not None:
        return  # rates where the gain may be off: LTPF never active
    assert active > 0, "no stream activated LTPF"
    # each of the fractional search's cases: pitch_int 32, below 127, below 157, above
    reached = [32 in pitch_ints, any(32 < p < 127 for p in pitch_ints),
               any(127 <= p < 157 for p in pitch_ints), max(pitch_ints) >= 157]
    assert all(reached), sorted(pitch_ints)


# every configuration at S = 37 and 40 B, and the benchmark cells' settings
STEP_CASES = [(c, 37, 40) for c in ALL_CONFIGS] + [(ALL_CONFIGS[5], 2048, 120),
                                                   (ALL_CONFIGS[1], 2048, 40)]
STEP_IDS = [f"{i}-S37" for i in CFG_IDS] + ["48000-10ms-S2048", "16000-10ms-S2048"]


@pytest.mark.card
@pytest.mark.parametrize("cfg,S,nbytes", STEP_CASES, ids=STEP_IDS)
def test_replayed_encode_step_equals_plain_on_the_card(cfg, S, nbytes, monkeypatch):
    """make_encode_step's replayed graph (the kernel inside) against the
    eager step with the plain LTPF analysis, T_FRAMES frames: every field
    of the step and the whole state equal, one kernel launch a replay."""
    dev = _card()
    pcm = torch.as_tensor(stress_pcm(cfg, S, T_FRAMES, seed=7) // 2
                          + corpus_pcm(cfg, S, T_FRAMES, seed=8) // 2, device=dev)
    step = E.make_encode_step(cfg, nbytes, device=dev)
    st = E.encoder_init(cfg, S, dev)
    got = []
    before = _build.launches["lc3t_ltpf_analysis"]
    for f in range(T_FRAMES):
        st, fields = step(st, pcm[f])
        got.append({k: v.clone() for k, v in fields.items() if torch.is_tensor(v)})
    assert _build.launches["lc3t_ltpf_analysis"] == before + T_FRAMES
    final = {f"{n}": v.clone() for n, v in _state_tensors(st)}
    monkeypatch.setattr(E, "ltpf_analysis", lambda *a: ltpf_analysis_plain(*a))
    ref = E.encoder_init(cfg, S, dev)
    for f in range(T_FRAMES):
        ref, fields = E.encode_step(cfg, nbytes, ref, pcm[f])
        _assert_equal(got[f], {k: v for k, v in fields.items() if torch.is_tensor(v)},
                      f"replayed step frame {f}")
    _assert_equal(final, dict(_state_tensors(ref)), "replayed step state")


def _state_tensors(st):
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            yield from ((f"{f.name}.{n}", t) for n, t in _state_tensors(v))
        else:
            yield f.name, v
