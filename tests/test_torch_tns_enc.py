"""lc3jax_torch encoder TNS (autocorrelation, analysis lattice and the whole
stage) against the JAX package and the oracle.

The JAX outputs come from tests/goldens/torch_encode.npz
(tools/gen_torch_encode_goldens.py): `tns_autocorr_pallas` and
`tns_analysis_pallas` in interpret mode, and `tns_analysis_batch` through
its XLA and its Pallas path, on 128 spectra with correlated lines at
48 kHz / 10 ms, 1200 bits.

Tolerances. The port sums each autocorrelation lag in the oracle's order,
one left-to-right f32 fold; JAX reduces with jnp.sum in XLA's order. So
a lag sum may differ by a few roundings of its terms, bounded here by 1e-6
of the block's lag-0 energy (which bounds every lag of the block; measured
4.7e-7). The lattice rounds every multiply and add on its own; XLA may
contract them into fma: bounded by 1e-6 of the row's largest magnitude
(measured 1.0e-7, 75% of rows exact). The integer fields (reflection
indices, orders, filter count, bits) are equal, and against the oracle's
own TNS golden the port is exact.
"""

import numpy as np
import pytest
import torch

from lc3jax.ref.fp import seq_sum
from lc3jax_torch import _build
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import encoder_tables
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.dsp import tns_enc_kernel as K

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
F32 = np.float32
RTOL = 1e-6


@pytest.fixture(scope="module")
def gold(goldens):
    g = goldens("torch_encode")
    out = {k[4:]: g[k] for k in g.files if k.startswith("tns_")}
    xla_bits = out["xla_x"].view(np.int32)
    for name in ("pallas_x", "lattice"):  # stored as ULP offsets from xla_x
        out[name] = (xla_bits + out.pop(name.replace("_x", "") + "_ulps")).view(F32)
    return out


def _t(a):
    return torch.as_tensor(a)


def _lattice_args(gold):
    return (_t(gold["x"]), _t(gold["bounds"]), _t(gold["xla_rc_order"]),
            _t(gold["xla_num_tns_filters"]), _t(gold["rc_q"]))


def _assert_rows_close(got, want):
    scale = np.abs(want).max(1, keepdims=True)
    assert (np.abs(got - want) <= RTOL * scale).all()


def test_tns_autocorr_plain_close_to_pallas_kernel(gold):
    got = K.tns_autocorr_plain(_t(gold["x"]), _t(gold["sub"])).numpy()
    want = gold["ac"]
    assert (np.abs(got - want) <= RTOL * want[..., :1]).all()


def test_tns_analysis_plain_close_to_pallas_kernel(gold):
    got = K.tns_analysis_plain(*_lattice_args(gold)).numpy()
    assert int(gold["xla_rc_order"].max()) == 8 and int(gold["xla_num_tns_filters"].max()) == 2
    _assert_rows_close(got, gold["lattice"])


def test_tns_analysis_batch_matches_jax(gold):
    tab = encoder_tables(CFG48, 1200)
    x_f, fields = E.tns_analysis_batch(tab, _t(gold["x"]), _t(gold["bw"]), 1200, _t(gold["nn"]))
    for k, v in fields.items():
        assert np.array_equal(np.asarray(v), gold[f"xla_{k}"]), k
    # the XLA and Pallas paths of JAX agree here; the port is held to both
    _assert_rows_close(x_f.numpy(), gold["xla_x"])
    _assert_rows_close(x_f.numpy(), gold["pallas_x"])


def test_tns_analysis_batch_matches_oracle_golden(goldens):
    """Autocorrelation, Levinson, weighting, quantisation and the lattice
    against ref/tns_enc.py, bit for bit."""
    g = goldens("tns_encode")
    tab = encoder_tables(CFG48, 1200)
    x_f, f = E.tns_analysis_batch(tab, _t(g["x_s"][None].astype(F32)), torch.tensor([4]), 1200,
                                  torch.tensor([False]))
    assert np.array_equal(x_f[0].numpy(), g["x_f_expected"])
    assert f["rc_i"][0].tolist() == [10, 7, 8, 9, 7, 9, 8, 9, 14, 11, 6, 9, 7, 9, 8, 8]
    assert f["rc_order"][0].tolist() == [8, 6]
    assert (int(f["nbits_tns"][0]), f["lpc_weighting"]) == (42, 0)


def test_tns_wrappers_take_plain_for_cpu_and_refuse_other_devices(gold):
    x, sub = _t(gold["x"][:4]), _t(gold["sub"][:4])
    args = [a[:4] for a in _lattice_args(gold)]
    before = _build.launches.copy()
    assert torch.equal(K.tns_autocorr(x, sub), K.tns_autocorr_plain(x, sub))
    assert torch.equal(K.tns_analysis(*args), K.tns_analysis_plain(*args))
    assert _build.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        K.tns_autocorr(x.to("meta"), sub)
    with pytest.raises(ValueError, match="unsupported device"):
        K.tns_analysis(args[0].to("meta"), *args[1:])


@pytest.mark.parametrize("fs,dur,bw", [(48000, FrameDuration.MS10, b) for b in range(5)]
                         + [(8000, FrameDuration.MS7P5, 0)])
def test_tns_autocorr_plain_is_the_oracles_fold(fs, dur, bw):
    """Each lag sum equals, bit for bit, the oracle's per-lag seq_sum of the
    rounded products (lc3jax/ref/tns_enc.py:_autocorrelation), which
    csrc/tns_autocorr.cu folds in the same order."""
    cfg = Lc3Config.new(fs, dur)
    sub = encoder_tables(cfg, 1200).tns_sub[torch.full((4,), bw)]
    rng = np.random.default_rng(10 * bw + cfg.fs_ind)
    x = (rng.standard_normal((4, cfg.ne)) * 10 ** rng.uniform(0, 3, (4, 1))).astype(F32)
    got = K.tns_autocorr_plain(torch.as_tensor(x), sub).numpy()
    want = np.zeros((4, 2, 3, 9), F32)
    for s, f, b, k in np.ndindex(4, 2, 3, 9):
        lo, hi = sub[s, f, b].tolist()
        if lo + k < hi:
            want[s, f, b, k] = seq_sum(x[s, lo : hi - k] * x[s, lo + k : hi])
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------- the lattice chunk by chunk


def _lattice_in_chunks(x, bounds, rc_order, num_filters, rc_q, chunk):
    """The analysis lattice as csrc/tns_analysis.cu splits it: each chunk of
    `chunk` lines starts from zero state, replays the (up to) 8 active lines
    before it, then runs its own lines and writes them. Vectorised over
    (stream, chunk) lanes; each line's update is tns_analysis_plain's, op for
    op, so equality with the plain version is the chunking argument."""
    S, ne = x.shape
    order = K._orders(rc_order, num_filters).long()
    b = bounds.reshape(S, 4).long()
    n = torch.arange(ne)[:, None]
    in_f0 = ((n >= b[:, 0]) & (n < b[:, 1]) & (order[:, 0] > 0)).t()  # [S, ne]
    in_f1 = ((n >= b[:, 2]) & (n < b[:, 3]) & (order[:, 1] > 0)).t()
    active = in_f0 | in_f1
    # each lane's lines: its warm-up (-1 where fewer than 8), then its chunk
    starts = range(0, ne, chunk)
    seq, lane_s, writes = [], [], []
    for s in range(S):
        act = active[s].nonzero().flatten().numpy()
        for n0 in starts:
            warm = act[act < n0][-8:]
            lines = list(range(n0, min(ne, n0 + chunk)))
            seq.append([-1] * (8 - len(warm)) + warm.tolist() + lines + [-1] * (chunk - len(lines)))
            lane_s.append(s)
            writes.append([False] * 8 + [True] * len(lines) + [False] * (chunk - len(lines)))
    seq, lane_s, writes = torch.tensor(seq), torch.tensor(lane_s), torch.tensor(writes)
    kk8 = torch.arange(8)
    rc0, rc1 = rc_q[lane_s, :8], rc_q[lane_s, 8:]
    out = x.clone()
    st = torch.zeros(len(lane_s), 8, dtype=x.dtype)
    for i in range(seq.shape[1]):
        li = seq[:, i].clamp(min=0)
        f1 = in_f1[lane_s, li]
        a = active[lane_s, li] & (seq[:, i] >= 0)
        o = torch.where(f1, order[lane_s, 1], order[lane_s, 0])
        rc = torch.where(f1[:, None], rc1, rc0)
        xn = x[lane_s, li]
        t = xn
        st_save = t
        cols = []
        for k in range(7):
            m = k < o - 1
            st_tmp = rc[:, k] * t + st[:, k]
            t = torch.where(m, t + rc[:, k] * st[:, k], t)
            cols.append(torch.where(m, st_save, st[:, k]))
            st_save = torch.where(m, st_tmp, st_save)
        new_st = torch.stack(cols + [st[:, 7]], 1)
        last = (o - 1).clamp(0, 7)
        rc_last = rc.gather(1, last[:, None])[:, 0]
        st_last = new_st.gather(1, last[:, None])[:, 0]
        t = t + rc_last * st_last
        new_st = torch.where(kk8[None, :] == last[:, None], st_save[:, None], new_st)
        st = torch.where(a[:, None], new_st, st)
        w = writes[:, i]
        out[lane_s[w], li[w]] = torch.where(a, t, xn)[w]
    return out


def _order_cases(rng, S):
    """Orders and filter counts with ord1 < ord0, ord1 > ord0, ord0 = 0 and
    num_filters = 1 with ord1 > 0 among random ones."""
    ro = rng.integers(0, 9, (S, 2))
    nf = rng.integers(1, 3, S)
    ro[0], ro[1], ro[2, 0], ro[3, 1], nf[:3], nf[3] = [7, 3], [2, 8], 0, 6, 2, 1
    return ro.astype(np.int32), nf.astype(np.int32)


@pytest.mark.parametrize("chunk", [1, 8, 32])
@pytest.mark.parametrize("fs,dur", [(48000, FrameDuration.MS10), (48000, FrameDuration.MS7P5),
                                    (8000, FrameDuration.MS10)], ids=["48k-10ms", "48k-7.5ms",
                                                                      "8k-10ms"])
def test_tns_analysis_in_chunks_equals_plain(fs, dur, chunk):
    """Chunks with an 8-active-line warm-up from zero state give the plain
    version bit for bit, over every bandwidth (at 8 kHz the wider ones have
    bounds past ne) and the order cases of _order_cases."""
    cfg = Lc3Config.new(fs, dur)
    tab = encoder_tables(cfg, 1200)
    S = 16
    rng = np.random.default_rng(cfg.ne + chunk)
    x = torch.as_tensor((rng.standard_normal((S, cfg.ne))
                         * 10 ** rng.uniform(0, 3, (S, 1))).astype(F32))
    bw = torch.as_tensor(np.r_[4, 4, 4, 4, rng.integers(0, 5, S - 4)])
    ro, nf = _order_cases(rng, S)
    rc_q = tab.tns_sin[torch.as_tensor(rng.integers(0, 17, (S, 16)))]
    args = (x, tab.tns_bounds[bw], torch.as_tensor(ro), torch.as_tensor(nf), rc_q)
    want = K.tns_analysis_plain(*args)
    assert int((want != x).any(1).sum()) >= S // 2  # the lattice ran on most streams
    assert torch.equal(_lattice_in_chunks(*args, chunk), want)
