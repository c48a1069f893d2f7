"""lc3jax_torch decoder stages against the oracle's per-stage goldens.

Residual, noise fill, global gain and the fast exp2 are bit-exact. SNS
rotates through a [16, 16] matmul where the oracle folds sequentially (the
JAX suite's bound: >= 385 of 400 lines exact, the rest <= 2 ulp). The
IMDCT takes its DCT-IV as a float64 product rounded once, the oracle a
kissfft in f32: measured 2 ulp of the output scale, bound 4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lc3jax.ref import fp
from lc3jax.ref.decoder_stages import mpvq_deenum as oracle_deenum
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.coding.device import device_parse_plain, mpvq_deenum
from lc3jax_torch.convert import decoder_tables
from lc3jax_torch.dsp import decoder as D

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
F32 = np.float32


def _tab(nbits=1200):
    return decoder_tables(CFG48, nbits)


def test_residual_apply_matches_golden(goldens):
    g = goldens("residual_decode")
    x_int = torch.as_tensor(g["x_hat"].astype(np.int32))[None]
    bits = torch.zeros_like(x_int, dtype=torch.bool)
    nz = x_int[0].nonzero().flatten()[: len(g["residual_bits"])]
    bits[0, nz] = torch.as_tensor(g["residual_bits"])  # aligned at each nonzero line
    got = D.residual_apply(_tab(), x_int.float(), x_int, bits,
                           torch.tensor([len(g["residual_bits"])]), torch.tensor([False]))
    assert np.array_equal(got[0].numpy(), g["expected"])


def test_noise_fill_matches_golden(goldens):
    g = goldens("noise_filling")
    x_int = torch.as_tensor(g["x_int"].astype(np.int32))[None]
    got = D.noise_fill(_tab(), torch.as_tensor(g["x_float"])[None], x_int,
                       torch.tensor([56909]), torch.tensor([4]), torch.tensor([3]),
                       torch.tensor([False]))
    assert np.array_equal(got[0].numpy(), g["expected"])


def test_global_gain_matches_oracle():
    got = D.global_gain(_tab(1200), torch.tensor([[1.0, 10.0, 100.0]]), torch.tensor([204]))
    assert np.array_equal(got[0].numpy(), np.array([61.0540199, 610.540199, 6105.40199], F32))


def test_sns_synthesis_near_exact(goldens):
    g = goldens("sns_decode")  # SnsVq(13, 4, ls_inda=1, ls_indb=0, 1718290, 2, 0, 0, g_ind=0)
    y = oracle_deenum(10, 10, 1, 1718290) + oracle_deenum(6, 1, 0, 2)
    got = D.sns_synthesis(_tab(), torch.as_tensor(g["x"])[None], torch.tensor([y]),
                          torch.tensor([0]), torch.tensor([0]), torch.tensor([13]),
                          torch.tensor([4]))[0].numpy()
    exp = g["expected"]
    assert np.count_nonzero(got == exp) >= 385
    ulps = np.abs(got.view(np.int32) - exp.view(np.int32))
    assert ulps.max() <= 2


@pytest.mark.parametrize("dim,k,ls,ind", [(10, 10, 1, 1718290), (6, 1, 0, 2), (16, 8, 0, 12345),
                                          (16, 6, 1, 999999), (10, 10, 0, 0)])
def test_mpvq_deenum_matches_oracle(dim, k, ls, ind):
    got = mpvq_deenum(1, dim, k, torch.tensor([ls]), torch.tensor([ind]), torch.tensor([True]))
    assert got[0, :dim].tolist() == oracle_deenum(dim, k, ls, ind)


def test_imdct_matches_golden(goldens):
    g = goldens("imdct")
    tab = _tab()
    mem = torch.zeros(1, CFG48.nf - CFG48.z)
    _, mem = D.imdct_ola(tab, torch.as_tensor(g["frame0"])[None], mem)
    out, _ = D.imdct_ola(tab, torch.as_tensor(g["frame1"])[None], mem)
    exp = g["expected"]
    assert np.abs(out[0].numpy() - exp).max() <= 4 * np.spacing(F32(np.abs(exp).max()))


def test_exp2_fast_bit_exact_over_sns_domain():
    """The SNS interpolated scale factors stay well inside [-32, 32]: every
    f32 on a 2^-10 grid there, plus values next to each integer."""
    grid = np.arange(-32 * 1024, 32 * 1024 + 1, dtype=np.float64) / 1024
    near = np.concatenate([np.nextafter(np.arange(-32, 33, dtype=F32), F32(s))
                           for s in (-np.inf, np.inf)])
    xs = np.concatenate([grid.astype(F32), near])
    got = D.exp2_fast(torch.as_tensor(xs)).numpy()
    want = np.array([fp.exp2_raw(v) for v in xs], dtype=F32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_output_scale_matches_oracle():
    x = torch.tensor([0.0, -0.4, -0.5, -0.6, 0.4, 0.5, 0.6, 32767.6, -32768.6, 1e9, -1e9])
    want = [0, 0, -1, -1, 0, 1, 1, 32767, -32768, 32767, -32768]
    assert D.output_scale(x).tolist() == want


def test_decode_step_golden_frame(goldens):
    """One real frame (150 B, 48 kHz) from fields to PCM, two streams."""
    g = goldens("decode_frame")
    pl = torch.as_tensor(np.stack([g["buf_in"], g["buf_in"]]).astype(np.uint8))
    frames = device_parse_plain(CFG48, 150, pl)
    _, pcm = D.decode_step(CFG48, 1200, D.decoder_init(CFG48, 2, device="cpu"), frames)
    for s in range(2):
        assert np.abs(pcm[s].numpy().astype(int) - g["pcm_expected"]).max() <= 1


def test_decode_step_debug_taps(goldens):
    g = goldens("decode_frame")
    frames = device_parse_plain(CFG48, 150, torch.as_tensor(g["buf_in"][None].astype(np.uint8)))
    st, (pcm, taps) = D.decode_step(CFG48, 1200, D.decoder_init(CFG48, 1, device="cpu"),
                                    frames, debug_taps=True)
    assert taps["x_spec"].shape == (1, CFG48.ne) and taps["t_pre_ltpf"].shape == (1, CFG48.nf)
    assert pcm.dtype == torch.int16 and pcm.shape == (1, CFG48.nf)
    assert [f.name for f in dataclasses.fields(st)][-1] == "ltpf"
