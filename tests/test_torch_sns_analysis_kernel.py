"""lc3jax_torch encoder SNS analysis: the wrappers of the two kernels around
the PVQ search (dsp/sns_analysis_kernel.py) and their plain versions on the
CPU; the kernels against their plain versions on the card, alone and
inside the replayed encode steps.

The plain versions (encoder.sns_front_plain, encoder.sns_finish_plain) are
the eager code that tests/test_torch_sns.py holds to the JAX package and to
the oracle's golden; here the wrapper is held to that same golden on the
CPU, and the kernels are held to the plain versions bit for bit
(`torch.equal`) on the card. The tests marked `card` need a CUDA card and
skip without one; this file imports no JAX, so on a machine with a card and
without JAX it runs from the repository's root as

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sns_analysis_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from lc3jax_torch import _build
from lc3jax_torch.config import ALL_CONFIGS, FrameDuration, Lc3Config
from lc3jax_torch.convert import encoder_tables
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.dsp import sns_analysis_kernel as K
from lc3jax_torch.dsp import sns_kernel

CFG_IDS = [f"{c.fs}-{c.n_ms.value}" for c in ALL_CONFIGS]
CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
NBITS = 960  # the SNS stage reads no bit budget: any frame size's tables do


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pcm_spectra(cfg, S: int, seed: int):
    """(x f32 [S, ne], a strided view, and e_b f32 [S, nb]): the second
    frame's MDCT of tones and noise at levels from silence to full scale, a
    level a stream; stream 0 silent (the noise floor), stream 1 a
    full-scale square wave, stream 2 full-scale noise."""
    tab = encoder_tables(cfg, NBITS)
    rng = np.random.default_rng(seed)
    n = np.arange(2 * cfg.nf)
    level = 10.0 ** rng.uniform(-5, 0, (S, 1))
    tone = np.sin(2 * np.pi * rng.uniform(50, cfg.fs / 2, (S, 1)) / cfg.fs * n)
    pcm = level * 32767 * np.where(rng.random((S, 1)) < 0.5, tone, rng.uniform(-1, 1, (S, n.size)))
    pcm[0] = 0.0
    pcm[1 % S] = np.where(tone[1 % S] < 0, -32768.0, 32767.0)
    pcm[2 % S] = rng.choice([-32768.0, 32767.0], n.size)
    pcm = torch.as_tensor(np.clip(pcm, -32768, 32767).astype(np.int16))
    buf = torch.zeros(S, 2 * cfg.nf)
    buf, _, _, _ = E.forward_mdct(tab, buf, pcm[:, : cfg.nf])
    _, x, e_b, _ = E.forward_mdct(tab, buf, pcm[:, cfg.nf :])
    return x, e_b


def _tilted(cfg, S: int, seed: int) -> torch.Tensor:
    """e_b f32 [S, nb]: spectra with random slopes, bumps and band-to-band
    noise over 22 decades, so that the scale factors and codebook rows
    vary widely."""
    rng = np.random.default_rng(seed)
    b = np.arange(cfg.nb) / cfg.nb
    db = (rng.uniform(-120, 60, (S, 1)) * b + rng.uniform(-60, 40, (S, 1))
          + rng.uniform(0, 50, (S, 1)) * np.exp(-((b - rng.uniform(0, 1, (S, 1))) * 8) ** 2)
          + rng.normal(0, rng.uniform(0, 12, (S, 1)), (S, cfg.nb)))
    return torch.as_tensor(10.0 ** (np.clip(db, -100, 120) / 10.0), dtype=torch.float32)


def _errors(tab, e_b, attack):
    return E.sns_codebook_errors(tab, E.sns_scale_factors(tab, e_b, attack))


def tie_rows(cfg, seed: int, per_half: int = 3):
    """(e_b f32 [n, nb], attack bool [n], half [n]): rows on which stage 1's
    least squared error is that of two codebook rows at once, in the low
    (half 0) or the high half (half 1), up to per_half of each with the
    attack smoothing on and off. Found by scaling one band of a tilted
    spectrum until the first minimum moves to another row, bisecting the
    scale to the edge, then stepping the band's f32 energy ulp by ulp
    across it."""
    tab = encoder_tables(cfg, NBITS)
    rng = np.random.default_rng(seed)
    found = {(h, a): [] for h in (0, 1) for a in (False, True)}
    for attempt in range(4):
        base = _tilted(cfg, 48, seed + 101 * attempt)
        n0 = base.shape[0]
        att0 = torch.as_tensor(np.arange(n0) % 2 == 1)
        band = torch.as_tensor(rng.integers(0, cfg.nb, n0))
        grid = torch.logspace(-5, 5, 129, dtype=torch.float64)
        rows = base[:, None, :].repeat(1, grid.numel(), 1)
        idx = torch.arange(n0)
        rows[idx, :, band] = (base[idx, band][:, None].double() * grid[None, :]).float()
        for h in (0, 1):
            err = _errors(tab, rows.reshape(-1, cfg.nb), att0.repeat_interleave(grid.numel()))[h]
            arg = err.argmin(1).reshape(n0, -1)
            flips = (arg[:, 1:] != arg[:, :-1]).nonzero()
            if flips.numel() == 0:
                continue
            r, g = flips[:, 0], flips[:, 1]
            lo, hi = grid[g].clone(), grid[g + 1].clone()
            want = arg[r, g]
            e0 = base[r, band[r]].double()
            for _ in range(48):  # bisect the scale: argmin want at lo, not at hi
                mid = (lo * hi).sqrt()
                trial = base[r].clone()
                trial[torch.arange(r.numel()), band[r]] = (e0 * mid).float()
                keep = _errors(tab, trial, att0[r])[h].argmin(1) == want
                lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
            start = (e0 * lo).float()
            steps = []
            v_up = v_dn = start
            for _ in range(48):
                steps += [v_up, v_dn]
                v_up = torch.nextafter(v_up, torch.full_like(v_up, float("inf")))
                v_dn = torch.nextafter(v_dn, torch.zeros_like(v_dn))
            cand_v = torch.stack(steps, 1)  # [flips, 96]
            cand = base[r][:, None, :].repeat(1, cand_v.shape[1], 1)
            cand[torch.arange(r.numel()), :, band[r]] = cand_v
            cand = cand.reshape(-1, cfg.nb)
            cand_att = att0[r].repeat_interleave(cand_v.shape[1])
            e = _errors(tab, cand, cand_att)[h]
            tie = (e == e.min(1, keepdim=True).values).sum(1) >= 2
            for i in tie.nonzero().flatten().tolist():
                key = (h, bool(cand_att[i]))
                if len(found[key]) < per_half and not any(torch.equal(cand[i], o)
                                                          for o in found[key]):
                    found[key].append(cand[i])
        if all(len(v) == per_half for v in found.values()):
            break
    e_b, attack, half = [], [], []
    for (h, a), v in found.items():
        e_b += v
        attack += [a] * len(v)
        half += [h] * len(v)
    return (torch.stack(e_b) if e_b else torch.zeros(0, cfg.nb), torch.as_tensor(attack),
            torch.as_tensor(half, dtype=torch.int64))


def shape_rows(cfg, seed: int):
    """(e_b f32 [4, nb], attack bool [4]): the first rows of a pool of
    tilted spectra whose PVQ search picks shape 0, 1, 2 and 3."""
    tab = encoder_tables(cfg, NBITS)
    e_b = _tilted(cfg, 512, seed)
    attack = torch.as_tensor(np.arange(512) % 3 == 0)
    t2rot = E.sns_front_plain(tab, e_b, attack)[0]
    shape_j = sns_kernel.sns_pvq_plain(t2rot)[3]
    pick = [int((shape_j == j).nonzero()[0]) for j in range(4)]
    return e_b[pick], attack[pick]


def sns_inputs(cfg, S: int, seed: int, attack_mode: str):
    """(x f32 [S, ne] strided, e_b f32 [S, nb], attack bool [S]) for the
    equality checks: the rows that reach every shape and the tie rows
    first (as many as S holds), then spectra of PCM (the first a silent
    frame, then full-scale square and noise) and tilted spectra, half and
    half. attack_mode "on", "off" or "mixed" sets the flags of the spectra
    (the shape and tie rows keep their own)."""
    rng = np.random.default_rng(seed)
    x, e_pcm = _pcm_spectra(cfg, S, seed)
    e_b = torch.where(torch.as_tensor(np.arange(S) % 2 == 0)[:, None], e_pcm,
                      _tilted(cfg, S, seed + 1))
    e_b[:3] = e_pcm[:3]
    flags = {"on": np.ones(S, bool), "off": np.zeros(S, bool), "mixed": rng.random(S) < 0.5}
    attack = torch.as_tensor(flags[attack_mode])
    ties, tie_att, _ = tie_rows(cfg, seed + 2)
    shapes, shape_att = shape_rows(cfg, seed + 3)
    head = torch.cat([shapes, ties])[: max(0, S - 3)]
    head_att = torch.cat([shape_att, tie_att])[: head.shape[0]]
    e_b[3 : 3 + head.shape[0]] = head
    attack[3 : 3 + head.shape[0]] = head_att
    return x, e_b.contiguous(), attack


def plain_sns(tab, x, e_b, attack):
    """The plain versions' stage: front, PVQ search, finish."""
    t2rot, st1, ind_lf, ind_hf = E.sns_front_plain(tab, e_b, attack)
    pvq = sns_kernel.sns_pvq_plain(t2rot)
    return (t2rot, st1, ind_lf, ind_hf), E.sns_finish_plain(tab, x, st1, ind_lf, ind_hf, *pvq)


# ------------------------------------------------------------- on the CPU


def test_wrapper_equals_the_goldens_on_the_cpu(goldens):
    """On CPU tensors the wrappers take the plain versions (no launch), and
    sns_analysis through them gives the JAX package's outputs
    (torch_encode's sns_ rows) and the oracle's SNS golden."""
    tab = encoder_tables(CFG48, 1200)
    g = goldens("torch_encode")
    before = _build.launches.copy()
    x_s, fields = E.sns_analysis(tab, torch.as_tensor(g["sns_in_x"]),
                                 torch.as_tensor(g["sns_in_e_b"]),
                                 torch.as_tensor(g["sns_in_attack"]))
    assert np.array_equal(x_s.numpy(), g["sns_out_x"])
    assert tuple(fields) == K.FIELDS
    for k, v in fields.items():
        assert v.dtype == torch.int32 and np.array_equal(v.numpy(), g[f"sns_out_{k}"]), k
    o = goldens("sns_encode")
    x_s, f = E.sns_analysis(tab, torch.as_tensor(o["x"][None].astype(np.float32)),
                            torch.as_tensor(o["e_b"][None].astype(np.float32)),
                            torch.tensor([True]))
    assert np.array_equal(x_s[0].numpy(), o["x_s_expected"])
    assert [int(f[k][0]) for k in K.FIELDS] == [8, 17, 3, 0, 0, 0, 15253432]
    assert _build.launches == before


@pytest.mark.parametrize("cfg", ALL_CONFIGS, ids=CFG_IDS)
def test_wrappers_take_the_plain_versions_on_the_cpu(cfg):
    """Every configuration, the attack flags mixed: each wrapper returns its
    plain version's outputs on a strided spectrum and launches nothing."""
    tab = encoder_tables(cfg, NBITS)
    x, e_b, attack = sns_inputs(cfg, 24, seed=cfg.fs + cfg.nf, attack_mode="mixed")
    assert x.stride(0) == cfg.nf  # the MDCT output's rows: strided where nf > ne
    before = _build.launches.copy()
    front = K.sns_front(tab, e_b, attack)
    pvq = sns_kernel.sns_pvq(front[0])
    got = K.sns_finish(tab, x, *front[1:], *pvq)
    want_front, want = plain_sns(tab, x, e_b, attack)
    assert _build.launches == before
    for a, b in zip(front, want_front):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got[0], want[0]) and got[1].keys() == want[1].keys()
    for k in K.FIELDS:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("cfg", [ALL_CONFIGS[5], ALL_CONFIGS[6]], ids=["48000-10ms", "8000-7.5ms"])
def test_input_rows_reach_ties_and_every_shape(cfg):
    """The card tests' inputs do what they are for: each tie row's least
    error belongs to two codebook rows, in both halves with the attack
    smoothing on and off; the shape rows reach shapes 0-3; the first row's
    bands all sit on the noise floor."""
    tab = encoder_tables(cfg, NBITS)
    e_b, attack, half = tie_rows(cfg, seed=cfg.fs + 2)
    assert {(int(h), bool(a)) for h, a in zip(half, attack)} == {
        (h, a) for h in (0, 1) for a in (False, True)}
    errs = _errors(tab, e_b, attack)
    for i, h in enumerate(half.tolist()):
        e = errs[h][i]
        assert int((e == e.min()).sum()) >= 2
    shapes, shape_att = shape_rows(cfg, seed=cfg.fs + 3)
    pvq = sns_kernel.sns_pvq_plain(E.sns_front_plain(tab, shapes, shape_att)[0])
    assert pvq[3].tolist() == [0, 1, 2, 3]
    x, e_b, _ = sns_inputs(cfg, 17, seed=3, attack_mode="off")
    assert not bool(e_b[0].any()) and not bool(x[0].any())


def _bad_args(case):
    """sns_front's and sns_finish's arguments with the one named fault."""
    cfg = CFG48
    tab = encoder_tables(cfg, NBITS)
    S = 3
    front = dict(e_b=torch.ones(S, cfg.nb), attack=torch.zeros(S, dtype=torch.bool))
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32)
    finish = dict(x=torch.ones(S, cfg.ne), st1=torch.zeros(S, 16),
                  ind_lf=torch.zeros(S, dtype=torch.int64),
                  ind_hf=torch.zeros(S, dtype=torch.int64),
                  y_sel=i32(S, 16), y0s=i32(S, 16), xq_sel=torch.zeros(S, 16), shape_j=i32(S),
                  gind=i32(S), g_sel=torch.zeros(S))
    site, name, fault = case.split(" ")
    args = front if site == "sns_front" else finish
    t = args.get(name)
    if fault == "dtype":
        args[name] = t.double() if t.is_floating_point() else t.float()
    elif fault == "shape":
        args[name] = t[..., :-1] if t.dim() == 2 else t[:-1]
    elif fault == "device":
        args[name] = t.to("meta")
    elif fault == "tables":
        tab = dataclasses.replace(tab, dct16=tab.dct16.to("meta"))
    elif fault == "meta":
        meta = {k: getattr(tab, k).to("meta")
                for k in ("preemph", "group_idx", "group_w", "lfcb", "hfcb", "dct16",
                          "mpvq_offsets", "band_of_line")}
        tab = dataclasses.replace(tab, **meta, divisors={
            k: v.to("meta") for k, v in tab.divisors.items()})
        args = {k: v.to("meta") for k, v in args.items()}
    fn = K.sns_front if site == "sns_front" else K.sns_finish
    return fn, tab, args


BAD_CASES = ([f"sns_front {n} {f}" for n in ("e_b", "attack") for f in ("dtype", "shape", "device")]
             + [f"sns_finish {n} {f}" for n in ("x", "st1", "ind_lf", "ind_hf", "y_sel", "y0s",
                                                 "xq_sel", "shape_j", "gind", "g_sel")
                for f in ("dtype", "shape", "device")]
             + ["sns_front - tables", "sns_finish - tables", "sns_front - meta",
                "sns_finish - meta"])


@pytest.mark.parametrize("case", BAD_CASES)
def test_wrappers_refuse_bad_arguments(case):
    """A wrong dtype, shape or device of any argument raises on every device
    (here the CPU), and so do tables on another device; a device that is
    neither the CPU nor a card raises too."""
    fn, tab, args = _bad_args(case)
    match = "unsupported device" if case.endswith("meta") else f"{fn.__name__}: .* must be"
    with pytest.raises(ValueError, match=match):
        fn(tab, *args.values())


# -------------------------------------------------------------- on the card


KERNEL_CASES = [(c, S, a) for c in ALL_CONFIGS for S in (1, 17, 2048) for a in ("off", "on")]
KERNEL_IDS = [f"{i}-S{S}-attack_{a}" for i in CFG_IDS for S in (1, 17, 2048) for a in ("off", "on")]


def _equal(label, got, want):
    if got.dtype != want.dtype or not torch.equal(got, want):
        bad = (got != want).reshape(got.shape[0], -1).any(1).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"{label}: streams {bad} differ ({got.dtype} vs {want.dtype})")


@pytest.mark.card
@pytest.mark.parametrize("cfg,S,attack_mode", KERNEL_CASES, ids=KERNEL_IDS)
def test_kernels_equal_plain_on_the_card(cfg, S, attack_mode):
    """The shape and tie rows, the silent, full-scale and seeded spectra,
    through both kernels and the PVQ search: t2rot, st1, both indices, the
    shaped spectrum and every field equal the plain versions'; one launch
    of each kernel a call."""
    dev = _card()
    tab = encoder_tables(cfg, NBITS, dev)
    x, e_b, attack = (t.to(dev) for t in sns_inputs(cfg, S, S + cfg.fs, attack_mode))
    before = {k: _build.launches[k] for k in ("lc3t_sns_front", "lc3t_sns_finish")}
    front = K.sns_front(tab, e_b, attack)
    pvq = sns_kernel.sns_pvq(front[0])
    x_s, fields = K.sns_finish(tab, x, *front[1:], *pvq)
    assert {k: _build.launches[k] - v for k, v in before.items()} == {
        "lc3t_sns_front": 1, "lc3t_sns_finish": 1}
    want_front = E.sns_front_plain(tab, e_b, attack)
    for name, a, b in zip(("t2rot", "st1", "ind_lf", "ind_hf"), front, want_front):
        _equal(name, a, b)
    want_x, want_fields = E.sns_finish_plain(tab, x, *want_front[1:],
                                             *sns_kernel.sns_pvq_plain(want_front[0]))
    _equal("x_shaped", x_s, want_x)
    for k in K.FIELDS:
        _equal(k, fields[k], want_fields[k])


STEP_CASES = ([(c, 37, 40) for c in ALL_CONFIGS]
              + [(ALL_CONFIGS[5], 2048, 120), (ALL_CONFIGS[1], 2048, 40),
                 (ALL_CONFIGS[11], 2048, 75)])
STEP_IDS = ([f"{i}-S37" for i in CFG_IDS]
            + ["48000-10ms-S2048", "16000-10ms-S2048", "48000-7.5ms-S2048"])
T_FRAMES = 6


def _pcm(cfg, S: int, seed: int) -> np.ndarray:
    """int16 [T_FRAMES, S, nf]: tones and noise at levels from silence to
    full scale, a level a stream, with clicks in every fifth stream (the
    attack detector's input)."""
    rng = np.random.default_rng(seed)
    n = np.arange(T_FRAMES * cfg.nf)
    level = 10.0 ** rng.uniform(-5, 0, (S, 1)) * (rng.random((S, 1)) > 0.05)
    tone = np.sin(2 * np.pi * rng.uniform(50, cfg.fs / 2, (S, 1)) / cfg.fs * n)
    x = level * 32767 * np.where(rng.random((S, 1)) < 0.5, tone, rng.uniform(-1, 1, (S, n.size)))
    x[::5, (n % (2 * cfg.nf)) == cfg.nf // 2] = 32767.0
    return np.clip(x, -32768, 32767).astype(np.int16).reshape(S, T_FRAMES, cfg.nf).transpose(1, 0, 2)


def _state_tensors(st, prefix=""):
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            yield from _state_tensors(v, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", v


@pytest.mark.card
@pytest.mark.parametrize("cfg,S,nbytes", STEP_CASES, ids=STEP_IDS)
def test_replayed_encode_steps_equal_plain_on_the_card(cfg, S, nbytes, monkeypatch):
    """The replayed graphs of the encode DSP step (the serving encoder's),
    the fused bytes step (the serving encoder with the device pack) and
    make_encode_step, the kernels inside all three, against the eager steps
    with the plain versions put in their place, T_FRAMES frames: every
    field, the whole state and every byte equal, one launch of each kernel
    a replay."""
    from lc3jax_torch.coding.device import encode_bytes_step
    from lc3jax_torch.serving import BatchEncoder

    dev = _card()
    pcm = torch.as_tensor(_pcm(cfg, S, seed=S + cfg.fs), device=dev)
    step = E.make_encode_step(cfg, nbytes, device=dev)
    dsp = BatchEncoder(cfg, S, nbytes, device=dev)
    fused = BatchEncoder(cfg, S, nbytes, device=dev, device_pack=True)
    st = E.encoder_init(cfg, S, dev)
    got, got_dsp, got_bytes = [], [], []
    names = ("lc3t_sns_front", "lc3t_sns_finish")
    before = {k: _build.launches[k] for k in names}
    for f in range(T_FRAMES):
        st, fields = step(st, pcm[f])
        got.append({k: v.clone() for k, v in fields.items() if torch.is_tensor(v)})
        got_dsp.append({k: v.clone() for k, v in dsp.encode_fields_tensor(pcm[f]).items()
                        if torch.is_tensor(v)})
        got_bytes.append(fused.encode_tensor(pcm[f]).clone())
    assert {k: _build.launches[k] - v for k, v in before.items()} == {k: 3 * T_FRAMES
                                                                       for k in names}
    final = {k: v.clone() for k, v in _state_tensors(st)}
    monkeypatch.setattr(E, "sns_front", E.sns_front_plain)
    monkeypatch.setattr(E, "sns_finish", E.sns_finish_plain)
    ref = ref_b = E.encoder_init(cfg, S, dev)
    for f in range(T_FRAMES):
        ref, fields = E.encode_step(cfg, nbytes, ref, pcm[f])
        want = {k: v for k, v in fields.items() if torch.is_tensor(v)}
        for label, have in (("make_encode_step", got[f]), ("BatchEncoder", got_dsp[f])):
            assert have.keys() == want.keys()
            for k, v in want.items():
                assert torch.equal(have[k], v), f"{label}, frame {f}: field {k}"
        ref_b, want_bytes = encode_bytes_step(cfg, nbytes, ref_b, pcm[f])
        assert torch.equal(got_bytes[f], want_bytes), f"frame {f}: bytes"
    ref_state = dict(_state_tensors(ref))
    assert final.keys() == ref_state.keys()
    for k, v in ref_state.items():
        assert torch.equal(final[k], v), f"state {k}"
