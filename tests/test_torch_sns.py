"""lc3jax_torch SNS encoder (stage-2 PVQ search and the whole analysis)
against the JAX package and the oracle.

The JAX outputs come from tests/goldens/torch_encode.npz
(tools/gen_torch_encode_goldens.py): `sns_pvq_pallas` in interpret mode on
random rotated residuals, and `sns_analysis` through its XLA path on random
spectra and band energies, at 48 kHz / 10 ms. Both packages fold every sum
left to right in f32 and break ties to the first lane, so the tolerance is
zero: every output is compared for equality.
"""

import numpy as np
import pytest
import torch

from lc3jax.dsp import encoder as JE
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import encoder_tables
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.dsp import sns_kernel

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
F32 = np.float32
PVQ_OUT = ("y_sel", "y0s", "xq_sel", "shape_j", "gind", "g_sel")


@pytest.fixture(scope="module")
def gold(goldens):
    g = goldens("torch_encode")
    return {k[4:]: g[k] for k in g.files if k.startswith("sns_")}


def test_sns_pvq_plain_equals_pallas_kernel(gold):
    got = sns_kernel.sns_pvq_plain(torch.as_tensor(gold["t2rot"]))
    for name, a in zip(PVQ_OUT, got):
        assert np.array_equal(a.numpy(), gold[name]), name
    # the golden's rows cover every shape, and row 0 has an empty set B
    assert set(np.unique(gold["shape_j"])) == {0, 1, 2, 3}


def test_sns_analysis_equals_jax(gold):
    tab = encoder_tables(CFG48, 1200)
    x_s, fields = E.sns_analysis(tab, torch.as_tensor(gold["in_x"]),
                                 torch.as_tensor(gold["in_e_b"]),
                                 torch.as_tensor(gold["in_attack"]))
    assert np.array_equal(x_s.numpy(), gold["out_x"])
    for k, v in fields.items():
        assert np.array_equal(v.numpy(), gold[f"out_{k}"]), k


def test_sns_analysis_matches_oracle_golden(goldens):
    """The oracle's own SNS golden (ref/sns_enc.py, attack on)."""
    g = goldens("sns_encode")
    tab = encoder_tables(CFG48, 1200)
    x_s, f = E.sns_analysis(tab, torch.as_tensor(g["x"][None].astype(F32)),
                            torch.as_tensor(g["e_b"][None].astype(F32)),
                            torch.tensor([True]))
    assert np.array_equal(x_s[0].numpy(), g["x_s_expected"])
    got = [int(f[k][0]) for k in ("ind_lf", "ind_hf", "shape_j", "gind", "ls_inda",
                                  "ls_indb", "index_joint_j")]
    assert got == [8, 17, 3, 0, 0, 0, 15253432]


def test_mpvq_enumeration_equals_jax():
    """The batched MPVQ index over random pulse vectors of every dimension."""
    rng = np.random.default_rng(5)
    S = 48
    dims = np.repeat(np.array([6, 10, 16]), S // 3)
    k = np.select([dims == 6, dims == 10], [1, 10], 6)
    y = np.zeros((S, 16), np.int32)
    for s in range(S):
        pos = rng.integers(0, dims[s], k[s])
        np.add.at(y[s], pos, 1)
        y[s] *= np.where(rng.uniform(size=16) < 0.5, -1, 1)
    tab = encoder_tables(CFG48, 1200)
    idx, ls = E._mpvq_enum_batch(tab, torch.as_tensor(y), torch.as_tensor(dims))
    want_idx, want_ls = JE._mpvq_enum_batch(y, dims.astype(np.int32))
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(ls.numpy(), np.asarray(want_ls))


def test_sns_pvq_wrapper_takes_plain_for_cpu_and_refuses_other_devices(gold):
    t2 = torch.as_tensor(gold["t2rot"][:5])
    before = sns_kernel.launches
    got = sns_kernel.sns_pvq(t2)
    assert sns_kernel.launches == before
    for a, b in zip(got, sns_kernel.sns_pvq_plain(t2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        sns_kernel.sns_pvq(t2.to("meta"))
