"""lc3jax_torch LTPF (plain passes) against the JAX LTPF and the oracle.

The JAX side is `ltpf_run(use_pallas=False)` on the random-state stress
inputs of tests/test_pallas_ltpf.py, stored with its outputs in
tests/goldens/torch_port.npz (tools/gen_torch_port_goldens.py), so this
file compiles no JAX program. The tolerance is that test's own: the FIR
folds run in another order than XLA's einsum and the IIR feedback
recirculates the ulps, so outputs differ below 0.01 and never by 0.5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.config import Lc3Config as JLc3Config
from lc3jax.dsp import ltpf as JL
from lc3jax.dsp.params import decoder_params
from lc3jax.ref.ltpf import LongTermPostFilter
from lc3jax.ref.side_info import LtpfInfo
from lc3jax_torch import _build
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import decoder_tables
from lc3jax_torch.dsp import ltpf as TL
from lc3jax_torch.dsp import ltpf_kernel

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
CASES = {"ltpf48": CFG48, "ltpf32": Lc3Config.new(32000, FrameDuration.MS7P5)}


@pytest.mark.parametrize("tag", sorted(CASES))
def test_ltpf_run_matches_jax_on_stress_inputs(goldens, tag):
    g = goldens("torch_port")
    cfg = CASES[tag]
    st = TL.LtpfState(**{f.name: torch.as_tensor(g[f"{tag}_st_{f.name}"])
                         for f in dataclasses.fields(TL.LtpfState)})
    t = lambda k: torch.as_tensor(g[f"{tag}_{k}"])
    y, new = TL.ltpf_run(decoder_tables(cfg, 1200), st, t("in_x"), 1200,
                         t("in_active"), t("in_pitch"))
    d = np.abs(y.numpy() - g[f"{tag}_y"])
    assert d.max() < 0.01, d.max()
    assert (d > 0.5).sum() == 0
    for f in dataclasses.fields(TL.LtpfState):
        got, want = getattr(new, f.name).numpy(), g[f"{tag}_out_{f.name}"]
        if f.name == "hist_y":
            assert np.abs(got - want).max() < 0.01, f.name
        else:
            assert np.array_equal(got, want), f.name


def test_ltpf_full_cycle_matches_oracle_golden(goldens):
    """The oracle golden's six frames through the transition cases."""
    g = goldens("ltpf_decode")
    infos = [(False, 134), (False, 132), (True, 134), (True, 136), (True, 136), (False, 132)]
    tab = decoder_tables(CFG48, 320)
    st = TL.ltpf_init(tab.p, 1)
    for k, (act, idx) in enumerate(infos):
        x = torch.as_tensor(g[f"frame_in_{k}"].astype(np.float32))[None]
        y, st = TL.ltpf_run(tab, st, x, 320, torch.tensor([act]),
                            torch.tensor([idx], dtype=torch.int32))
        err = np.abs(y[0].numpy() - g[f"frame_out_{k}"]).max()
        assert err < 2e-3, f"frame {k}: {err}"


def test_ltpf_all_transitions_vs_oracle():
    """Inactive, fade-in, steady, pitch change, fade-out and the 440+ pitch
    range against the numpy oracle filter (the JAX suite's bound)."""
    tab = decoder_tables(CFG48, 640)
    rng = np.random.default_rng(0)
    seq = [(False, 0), (True, 300), (True, 300), (True, 320), (False, 0),
           (True, 300), (True, 440), (True, 443)]
    ref = LongTermPostFilter(JLc3Config.new(48000, JFrameDuration.MS10))
    st = TL.ltpf_init(tab.p, 1)
    for i, (act, idx) in enumerate(seq):
        x = rng.standard_normal(480).astype(np.float32) * 1000
        yo = ref.run(LtpfInfo(True, act, idx), 640, x.copy())
        y, st = TL.ltpf_run(tab, st, torch.as_tensor(x)[None], 640, torch.tensor([act]),
                            torch.tensor([idx], dtype=torch.int32))
        err = np.abs(y[0].numpy() - yo).max()
        assert err < 2e-3, f"frame {i} (act={act} idx={idx}): {err}"


@pytest.mark.parametrize("fs,dur", [(8000, FrameDuration.MS10), (16000, FrameDuration.MS7P5),
                                    (44100, FrameDuration.MS10), (48000, FrameDuration.MS7P5)])
def test_pitch_lag_and_reach_back_match_jax(fs, dur):
    p = decoder_tables(Lc3Config.new(fs, dur), 1200).p
    jp = decoder_params(JLc3Config.new(fs, JFrameDuration(dur.value)))
    assert TL._reach_back(p) == JL._reach_back(jp)
    pi = np.arange(512, dtype=np.int32)
    want = [np.asarray(a) for a in JL._filter_params(jp, pi)]
    got = [a.numpy() for a in TL._filter_params(p, torch.as_tensor(pi))]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_ltpf_wrapper_takes_plain_for_cpu(goldens):
    g = goldens("torch_port")
    tab = decoder_tables(CFG48, 1200)
    st = TL.LtpfState(**{f.name: torch.as_tensor(g[f"ltpf48_st_{f.name}"])
                         for f in dataclasses.fields(TL.LtpfState)})
    t = lambda k: torch.as_tensor(g[f"ltpf48_{k}"])
    args = TL.ltpf_pass_args(tab, st, t("in_x"), t("in_active"), t("in_pitch"))[0]
    before = _build.launches.copy()
    ya, yb = ltpf_kernel.ltpf_both_passes(*args)
    assert _build.launches == before
    pa, pb = ltpf_kernel.ltpf_both_passes_plain(*args)
    assert torch.equal(ya, pa) and torch.equal(yb, pb)


@pytest.mark.parametrize("fs,dur,nbytes", [(48000, FrameDuration.MS10, 75),
                                           (48000, FrameDuration.MS7P5, 56),
                                           (8000, FrameDuration.MS10, 40)])
def test_ltpf_passes_read_only_the_window_the_kernel_stages(fs, dur, nbytes):
    """Both passes read hist_y only from H - rb on and xcat only from
    H - l_num on (the window csrc/ltpf.cu keeps in shared memory): random
    values before it leave the outputs bit-identical. Random-state inputs
    with pitch lags 18..855 and, in the first stream, the longest lag the
    geometry has, so its offset reaches H - rb exactly."""
    tab = decoder_tables(Lc3Config.new(fs, dur), nbytes * 8)
    p = tab.p
    H = p.num_mem_blocks * p.nf
    S = 16
    rng = np.random.default_rng(fs + nbytes)
    f = lambda *shape, scale: torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))
    lags = rng.integers(18, 856, S).astype(np.int32)
    lags[0] = TL._reach_back(p) - (p.l_den - p.l_den // 2)
    st = TL.LtpfState(
        hist_x=f(S, H, scale=1000), hist_y=f(S, H, scale=1000),
        c_num=f(S, p.l_num + 1, scale=0.2), c_den=f(S, p.l_den + 1, scale=0.2),
        p_int=torch.as_tensor(lags),
        p_fr=torch.as_tensor(rng.integers(0, 4, S).astype(np.int32)),
        active=torch.as_tensor(rng.integers(0, 2, S).astype(bool)))
    args = list(TL.ltpf_pass_args(tab, st, f(S, p.nf, scale=2000),
                                  torch.as_tensor(rng.integers(0, 2, S).astype(bool)),
                                  torch.as_tensor(rng.integers(0, 512, S).astype(np.int32)))[0])
    rb = args[-1]
    want = ltpf_kernel.ltpf_both_passes_plain(*args)
    args[1] = args[1].clone()
    args[1][:, : H - p.l_num] = f(S, H - p.l_num, scale=1e6)
    args[2] = args[2].clone()
    args[2][:, : H - rb] = f(S, H - rb, scale=1e6)
    got = ltpf_kernel.ltpf_both_passes_plain(*args)
    for g_, w in zip(got, want):
        assert np.array_equal(g_.numpy().view(np.int32), w.numpy().view(np.int32))
