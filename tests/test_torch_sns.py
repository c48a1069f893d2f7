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
from lc3jax_torch import _build
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
    before = _build.launches.copy()
    got = sns_kernel.sns_pvq(t2)
    assert _build.launches == before
    for a, b in zip(got, sns_kernel.sns_pvq_plain(t2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        sns_kernel.sns_pvq(t2.to("meta"))


# The CUDA kernel's split (csrc/sns_pvq.cu), modelled per stream in float32
# numpy: the greedy rounds in the plain version's order, only those a stream
# needs, a pulse's new accumulators taken from its candidate's values; each
# shape's norm from the integer sum of its squares; each of the 14
# candidates folded alone; and the search's first minimum as a pairwise tree
# over the stream's 16 lanes (lane k holds candidate k), the higher range
# winning only when strictly smaller.
_CANDS = [(0, 0), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)] + [(3, g) for g in range(7)]


def _first_min_tree(vals):
    """The index of the first minimum of vals (16 lanes), adjacent ranges merged."""
    items = list(zip(vals, range(len(vals))))
    while len(items) > 1:
        items = [hi if hi[0] < lo[0] else lo for lo, hi in zip(items[0::2], items[1::2])]
    return items[0][1]


def _greedy(y, ax, acc, nact):
    corr_l, energy_l = acc[0], acc[1]
    cc = [F32(corr_l + ax[n]) for n in range(nact)]
    ce = [F32(F32(energy_l + F32(2.0) * F32(y[n])) + F32(1.0)) for n in range(nact)]
    nb = 0
    for lane in range(1, nact):
        if F32(F32(cc[lane] * cc[lane]) * ce[nb]) > F32(F32(cc[nb] * cc[nb]) * ce[lane]):
            nb = lane
    y[nb] += 1  # the new accumulators are the pulse's own candidate values
    return [cc[nb], ce[nb], cc[nact - 1], ce[nact - 1]]


def _kernel_split_pvq(x):
    x = x.astype(F32)
    ax = np.abs(x)
    abs_sum = ax[0]
    for n in range(1, 16):
        abs_sum = F32(abs_sum + ax[n])
    proj = F32(F32(5.0) / abs_sum)
    y3 = [int(np.floor(F32(ax[n] * proj))) for n in range(16)]
    corr, energy = F32(F32(y3[0]) * ax[0]), F32(F32(y3[0]) * F32(y3[0]))
    for n in range(1, 16):
        corr = F32(corr + F32(F32(y3[n]) * ax[n]))
        energy = F32(energy + F32(F32(y3[n]) * F32(y3[n])))
    acc = [corr, energy, corr, energy]
    for _ in range(max(0, 6 - sum(y3))):
        acc = _greedy(y3, ax, acc, 16)
    y2 = list(y3)
    acc[:2] = acc[2:]
    for _ in range(2):
        acc = _greedy(y2, ax, acc, 16)
    y1 = [y2[n] if n < 10 else 0 for n in range(16)]
    kb = sum(y2[10:])
    acc[:2] = acc[2:]
    for n in range(10, 16):
        if y2[n]:
            acc[0] = F32(acc[0] - F32(F32(y2[n]) * ax[n]))
            acc[1] = F32(acc[1] - F32(F32(y2[n]) * F32(y2[n])))
    for _ in range(min(10, 2 + kb)):
        acc = _greedy(y1, ax, acc, 10)
    nb_best = 10 + int(np.argmax(ax[10:]))  # the first maximum, as the plain scan's
    y0 = [1 if n == nb_best else y1[n] for n in range(16)]
    sg = [-1 if x[n] < 0 else 1 for n in range(16)]
    ys = [[v * s for v, s in zip(y, sg)] for y in (y0, y1, y2, y3)]

    def normalized(j):
        yf = [F32(ys[j][n]) if j != 1 or n < 10 else F32(0.0) for n in range(16)]
        norm = np.sqrt(F32(sum(v * v for v in ys[j])))  # an integer sum
        return [F32(v / norm) if v != 0 else v for v in yf]

    mse = []
    for j, gi in _CANDS:  # one fold a candidate, each alone
        xq, gv = normalized(j), F32(sns_kernel.GAINS[j, gi])
        m = None
        for n in range(16):
            d = F32(x[n] - F32(gv * xq[n]))
            m = F32(d * d) if m is None else F32(m + F32(d * d))
        mse.append(m)
    j, gi = _CANDS[_first_min_tree(mse + [F32(np.inf)] * (16 - len(mse)))]
    return (ys[j], ys[0], normalized(j), j, gi, F32(sns_kernel.GAINS[j, gi]))


def _forced_ties():
    """Rows whose ties decide the result: equal |x| in set B, across the set-A/
    set-B edge and on every lane, an all-zero set B, zeros and -0.0; and a
    single pulse at a magnitude halfway between two searched gains (of one
    shape, and of shapes 1 and 2), so that two candidates' errors tie."""
    rng = np.random.default_rng(17)
    rows = (rng.standard_normal((48, 16)) * 3).astype(F32)
    rows[0:8, 10:] = 0.0
    rows[8:16, 10:] = F32(1.25) * np.where(rng.uniform(size=(8, 6)) < 0.5, -1, 1)
    rows[16:24, 8:12] = F32(2.5)
    rows[16:24, 2] = F32(-2.5)
    rows[24:32] = np.round(rows[24:32])
    rows[32:36] = F32(0.75) * np.where(rng.uniform(size=(4, 16)) < 0.5, -1, 1)
    rows[36:40, 12:] = -0.0
    rows[40:44, :6] = 0.0
    g = sns_kernel.GAINS
    for r, (a, b) in enumerate([(g[3, 0], g[3, 1]), (g[3, 2], g[3, 3]), (g[1, 0], g[2, 0]),
                                (g[2, 1], g[2, 2])]):
        rows[44 + r] = 0.0
        rows[44 + r, r * 3] = F32((F32(a) + F32(b)) / 2) * (-1 if r % 2 else 1)
    return rows


def test_sns_pvq_kernel_split_equals_plain(gold):
    """The kernel's split equals sns_pvq_plain on the golden's t2rot and on
    rows with forced ties (each output, exactly)."""
    ties = _forced_ties()
    for rows in (gold["t2rot"], ties):
        want = [a.numpy() for a in sns_kernel.sns_pvq_plain(torch.as_tensor(rows))]
        for s in range(rows.shape[0]):
            got = _kernel_split_pvq(rows[s])
            for name, a, b in zip(PVQ_OUT, got, want):
                assert np.array_equal(np.asarray(a, dtype=b.dtype), b[s]), (s, name)
    # the tie rows do tie: several with set B's maximum twice
    top = np.sort(np.abs(ties[:, 10:]), 1)
    assert (top[:, -1] == top[:, -2]).sum() > 8
