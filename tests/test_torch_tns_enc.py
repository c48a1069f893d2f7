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

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lc3jax.ref.fp import seq_sum
from lc3jax_torch import _build
from lc3jax_torch import tables as T
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import encoder_tables
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.dsp import tns_enc_kernel as K

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import division_check  # noqa: E402
import tns_cases  # noqa: E402

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
    tab = encoder_tables(CFG48, 1200)
    coef = (tab, _t(gold["x"][:4]), _t(gold["bw"][:4]), _t(gold["nn"][:4]), 0)
    args = [a[:4] for a in _lattice_args(gold)]
    before = _build.launches.copy()
    for got, want in zip(K.tns_coefficients(*coef), K.tns_coefficients_plain(*coef)):
        assert torch.equal(got, want)
    assert torch.equal(K.tns_analysis(*args), K.tns_analysis_plain(*args))
    assert _build.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        K.tns_coefficients(tab, coef[1].to("meta"), *coef[2:])
    with pytest.raises(ValueError, match="unsupported device"):
        K.tns_analysis(args[0].to("meta"), *args[1:])


@pytest.mark.parametrize("fs,dur,bw", [(48000, FrameDuration.MS10, b) for b in range(5)]
                         + [(8000, FrameDuration.MS7P5, 0)])
def test_tns_autocorr_plain_is_the_oracles_fold(fs, dur, bw):
    """Each lag sum equals, bit for bit, the oracle's per-lag seq_sum of the
    rounded products (lc3jax/ref/tns_enc.py:_autocorrelation), which
    csrc/tns_coefficients.cu folds in the same order."""
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


# ------------------------------------------- the coefficient kernel's plain version


def _coef_rows(cfg, S, seed):
    """chip_smoke.py's TNS coefficient cases (tools/tns_cases.py's
    coef_rows: white noise, AR(1) rows around the prediction gains 1.5 and
    2.0, all-zero and tiny rows, a zero stretch, tones; every bandwidth of
    cfg, near_nyquist rows) as CPU tensors."""
    return tuple(torch.as_tensor(a) for a in tns_cases.coef_rows(cfg, S, seed))


def _old_glue(tab, x, bw_ind, near_nyquist, lpc_weighting):
    """The TNS stage's glue as dsp/encoder.py ran it before the coefficient
    kernel (its lines 496-577), on tns_autocorr_plain's sums: the pre-port
    composition the plain version must equal. The divisor is a Python
    float here, as it was (on the CPU that divides)."""
    S = x.shape[0]
    bw = bw_ind.long()
    num_filters = torch.where(bw >= 3, 2, 1).to(torch.int32)
    ac_all = K.tns_autocorr_plain(x, tab.tns_sub[bw])
    rc_q = torch.zeros(S, 16, dtype=torch.float32)
    rc_i = torch.full((S, 16), 8, dtype=torch.int64)
    rc_order = torch.zeros(S, 2, dtype=torch.int32)
    one_minus_085 = float(F32(1.0) - F32(0.85))
    for f in range(2):
        es = ac_all[:, f, :, 0]
        e_prod = (es[:, 0] * es[:, 1]) * es[:, 2]
        ok = es != 0.0
        rs = []
        for k in range(9):
            q = torch.where(ok, ac_all[:, f, :, k] / es, 0.0)
            rk = (q[:, 0] + q[:, 1]) + q[:, 2]
            rs.append(torch.where(e_prod == 0.0, 3.0 if k == 0 else 0.0, rk) * tab.lag_window[k])
        r = torch.stack(rs, 1)
        a = [torch.ones(S)] + [torch.zeros(S)] * 8
        e = r[:, 0]
        for k in range(1, 9):
            rc = torch.zeros(S)
            for n in range(k):
                rc = rc - a[n] * r[:, k - n]
            rc = torch.where(e != 0.0, rc / e, rc)
            new_a = list(a)
            for n in range(1, k):
                new_a[n] = a[n] + rc * a[k - n]
            new_a[k] = rc
            a = new_a
            e = e * (1.0 - rc * rc)
        pred_gain = torch.where(e == 0.0, r[:, 0], r[:, 0] / e)
        on = (pred_gain > 1.5) & ~near_nyquist
        gamma = torch.where((lpc_weighting > 0) & (pred_gain < 2.0),
                            1.0 - (one_minus_085 * (2.0 - pred_gain)) / 0.5,
                            torch.ones_like(pred_gain))
        a = [a[k] * K._powi(gamma, k) for k in range(9)]
        rc_f = [None] * 8
        a_k = a
        for k in range(8, 0, -1):
            rck = a_k[k]
            rc_f[k - 1] = rck
            ee = 1.0 - rck * rck
            new_a = list(a_k)
            for n in range(1, k):
                new_a[n] = (a_k[n] - rck * a_k[k - n]) / ee
            a_k = new_a
        rc_f = torch.where(on[:, None], torch.stack(rc_f, 1), 0.0)
        q = torch.asin(rc_f.double()).float() / float(tab.tns_step)
        qi = torch.where(q >= 0.0, (q + 0.5).to(torch.int64), -((-q + 0.5).to(torch.int64)))
        rci_f = qi + 8
        order = torch.where(rci_f != 8, torch.arange(1, 9), 0).amax(1)
        exists = f < num_filters
        rc_i[:, 8 * f : 8 * f + 8] = torch.where(exists[:, None], rci_f, 8)
        rc_q[:, 8 * f : 8 * f + 8] = torch.where(exists[:, None], tab.tns_sin[rci_f.clamp(0, 16)], 0.0)
        rc_order[:, f] = torch.where(exists, order, 0)
    nbits_tns = torch.zeros(S, dtype=torch.int64)
    ks = torch.arange(8)
    order_bits = torch.as_tensor(np.asarray(T.AC_TNS_ORDER_BITS, np.int64))
    coef_bits = torch.as_tensor(np.asarray(T.AC_TNS_COEF_BITS, np.int64))
    for f in range(2):
        o = rc_order[:, f]
        nb_order = torch.where(o > 0, order_bits[lpc_weighting][(o - 1).clamp(min=0)], 0)
        per_k = coef_bits[ks[None, :], rc_i[:, 8 * f : 8 * f + 8]]
        nb_coef = torch.where(ks[None, :] < o[:, None], per_k, 0).sum(1)
        add = torch.ceil((2048.0 + nb_order.float() + nb_coef.float()) / 2048.0).long()
        nbits_tns = nbits_tns + torch.where(f < num_filters, add, 0)
    return ac_all, rc_i.to(torch.int32), rc_q, rc_order, nbits_tns.to(torch.int32)


@pytest.mark.parametrize("lpc_weighting", [0, 1])
@pytest.mark.parametrize("dur", [FrameDuration.MS10, FrameDuration.MS7P5], ids=["10ms", "7.5ms"])
def test_tns_coefficients_plain_equals_the_pre_port_composition(dur, lpc_weighting):
    """tns_coefficients_plain (the kernel's plain version) gives the five
    outputs of tns_autocorr_plain and the glue it replaced, at 48 kHz, on
    the edge cases of _coef_rows: every bandwidth (one filter and two),
    near_nyquist rows, es = 0, e_prod underflowing, prediction gains on
    both sides of 1.5 and 2.0, with and without the LPC weighting."""
    cfg = Lc3Config.new(48000, dur)
    tab = encoder_tables(cfg, 1200)
    x, bw, nn = _coef_rows(cfg, 48, 31 + lpc_weighting)
    got = K.tns_coefficients_plain(tab, x, bw, nn, lpc_weighting)
    for i, (g, w) in enumerate(zip(got, _old_glue(tab, x, bw, nn, lpc_weighting))):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    # the cases reach what they name
    _, pg = K.tns_lpc_plain(tab, got[0], nn, lpc_weighting)
    on = pg[:, 0][~nn]
    assert ((on > 1.0) & (on < 1.5)).any() and ((on > 1.5) & (on < 2.0)).any() and (on > 2.0).any()
    es = got[0][:, :, :, 0]
    assert (es == 0).all(2).any() and ((es.prod(2) == 0) & (es != 0).all(2)).any()
    assert int(got[3][:, 0].min()) == 0 and int(got[3][:, 0].max()) >= 6 and (got[3][:, 1] > 0).any()
    assert (got[4] == 1).any() and (got[4] > 10).any()


def test_tns_coefficients_plain_equals_the_oracle():
    """Against lc3jax/ref/tns_enc.py:tns_encode row by row: rc_i, rc_q,
    rc_order and nbits_tns bit for bit, at 48 kHz / 10 ms and 16 kHz /
    7.5 ms, with nbits on both sides of the LPC-weighting threshold."""
    from lc3jax.config import FrameDuration as OFD
    from lc3jax.config import Lc3Config as OCfg
    from lc3jax.ref.tns_enc import tns_encode

    for fs, dur, odur, nbits in ((48000, FrameDuration.MS10, OFD.MS10, 400),
                                 (48000, FrameDuration.MS10, OFD.MS10, 1200),
                                 (16000, FrameDuration.MS7P5, OFD.MS7P5, 300),
                                 (16000, FrameDuration.MS7P5, OFD.MS7P5, 600)):
        cfg = Lc3Config.new(fs, dur)
        ocfg = OCfg.new(fs, odur)
        tab = encoder_tables(cfg, nbits)
        x, bw, nn = _coef_rows(cfg, 16, nbits)
        weighting = int(nbits < (480 if dur == FrameDuration.MS10 else 360))
        _, rc_i, rc_q, rc_order, nbits_tns = K.tns_coefficients_plain(tab, x, bw, nn, weighting)
        for s in range(16):
            want = tns_encode(ocfg, x[s].numpy().copy(), int(bw[s]), nbits, bool(nn[s]))
            assert want.lpc_weighting == weighting
            assert rc_i[s].tolist() == want.rc_i and rc_order[s].tolist() == want.rc_order, s
            assert np.array_equal(rc_q[s].numpy(), want.rc_q) and int(nbits_tns[s]) == want.nbits_tns


def test_tns_coefficients_plain_on_the_oracle_golden_and_the_jax_fields(gold, goldens):
    """The oracle's TNS golden (ref/tns_enc.py on a real 48 kHz frame) and
    the JAX tns_analysis_batch's integer fields on the 128 stored spectra."""
    tab = encoder_tables(CFG48, 1200)
    g = goldens("tns_encode")
    _, rc_i, _, rc_order, nbits_tns = K.tns_coefficients_plain(
        tab, _t(g["x_s"][None].astype(F32)), torch.tensor([4], dtype=torch.int32),
        torch.tensor([False]), 0)
    assert rc_i[0].tolist() == [10, 7, 8, 9, 7, 9, 8, 9, 14, 11, 6, 9, 7, 9, 8, 8]
    assert rc_order[0].tolist() == [8, 6] and int(nbits_tns[0]) == 42
    out = K.tns_coefficients_plain(tab, _t(gold["x"]), _t(gold["bw"]), _t(gold["nn"]),
                                   int(gold["xla_lpc_weighting"]))
    for name, got in zip(("rc_i", "rc_order", "nbits_tns"), (out[1], out[3], out[4])):
        assert np.array_equal(got.numpy(), gold[f"xla_{name}"]), name
    assert np.array_equal(np.where(gold["bw"] >= 3, 2, 1), gold["xla_num_tns_filters"])


def test_tns_quantiser_takes_the_knife_edge_as_the_oracle():
    """rc = +-0.9829731: asinf(rc) / (pi/17) is +-7.4999995 in the oracle,
    so rc_i is 15 and 1; a reciprocal multiply gives +-7.5 and 16 and 0,
    which is what a CUDA card did with a Python float as the divisor
    (tools/division_check.py). tab.tns_step is a tensor, so the plain
    quantiser divides on either device."""
    from lc3jax.ref import fp as ofp

    tab = encoder_tables(CFG48, 1200)
    rc = torch.tensor([0.9829731, -0.9829731], dtype=torch.float32)
    step = F32(np.pi / 17.0)
    oracle = []
    for v in rc.numpy():
        q = ofp.asinf(v) / step
        oracle.append((int(q + F32(0.5)) if q >= 0.0 else -int(-q + F32(0.5))) + 8)
    assert oracle == [15, 1]
    assert isinstance(tab.tns_step, torch.Tensor) and tab.tns_step.dtype == torch.float32
    assert K.tns_quantise_plain(tab, rc).tolist() == oracle
    # the reciprocal multiply a card made of `/ float`, for the record
    recip = torch.asin(rc.double()).float() * torch.tensor(1.0 / step, dtype=torch.float32)
    assert (torch.round(recip.abs()) * recip.sign() + 8).tolist() == [16.0, 0.0]


def test_encoder_divides_by_device_tensors():
    """Every non-power-of-two constant the encoder divides a tensor by is a
    0-dim f32 tensor of its tables on their device (encoder_tables'
    divisors, named by site), and dsp/encoder.py has no `/ <number>` left
    but by powers of two."""
    for fs, dur in ((48000, FrameDuration.MS10), (8000, FrameDuration.MS7P5),
                    (32000, FrameDuration.MS7P5)):
        cfg = Lc3Config.new(fs, dur)
        tab = encoder_tables(cfg, 1200)
        p = tab.p
        t1, t2 = E.GAIN_ADJUST_T1[cfg.fs_ind], E.GAIN_ADJUST_T2[cfg.fs_ind]
        want = {"sns_attack_5": 5.0, "sns_attack_3": 3.0, "gain_estimate": 20.0,
                "gain_limit": 32767.625, "gain_adjust": float(F32(t2) - F32(t1)),
                "gain_adjust_48": 48.0, "tns_step": float(F32(np.pi / 17.0)),
                **{f"bandwidth_width_{k}": float(p.bw_stop[k] + 1 - p.bw_start[k])
                   for k in range(cfg.fs_ind)}}
        assert {k: float(t) for k, t in tab.divisors.items()} == want
        assert all(t.dim() == 0 and t.dtype == torch.float32 for t in tab.divisors.values())
        assert tab.divisors["tns_step"] is tab.tns_step
    src = Path(E.__file__).read_text()
    # the table builders (numpy, F32 scalars) aside
    code = "\n".join(ln.split("#")[0] for ln in src.splitlines()
                     if "np." not in ln and "F32(" not in ln)
    literals = {float(m) for m in re.findall(r"[^/]/ *([0-9]+\.[0-9]*)", code)}
    assert all(np.log2(v) == int(np.log2(v)) for v in literals), literals


def test_bandwidth_detector_takes_the_knife_edge_as_the_oracle(monkeypatch):
    """tools/division_check.py's witness E_B at 48 kHz / 10 ms: band 0's
    E_B / 9 folds to 19.999998 in the oracle, below its threshold 20, so
    bw_ind is 0; the reciprocal multiply a card made of `/ 9.0` folds to
    20.0 and, through stage 2, to 4. The port divides by the tables'
    bandwidth_width_0 and gives the oracle's 0."""
    from lc3jax.config import FrameDuration as JF
    from lc3jax.config import Lc3Config as JC
    from lc3jax.ref.encoder_stages import BandwidthDetector

    e_b = division_check.bandwidth_witness()
    assert BandwidthDetector(JC.new(48000, JF.MS10)).run(e_b[0]) == (division_check.BW_WITNESS_IND, 3)
    tab = encoder_tables(CFG48, 1200)
    bw, nbits = E.bandwidth_detect(tab, torch.as_tensor(e_b))
    assert bw.tolist() == [division_check.BW_WITNESS_IND] and nbits == 3
    # the two folds of band 0, and the detector with the division a card
    # made of `/ 9.0` (times the f32 reciprocal), for the record
    band0 = np.asarray(division_check.BW_WITNESS_BAND0, F32)
    assert seq_sum(band0 / F32(9.0)) == F32(19.999998)
    assert seq_sum(band0 * (F32(1.0) / F32(9.0))) == F32(20.0)
    div, width = torch.Tensor.__truediv__, tab.divisors["bandwidth_width_0"]
    monkeypatch.setattr(torch.Tensor, "__truediv__",
                        lambda a, b: a * torch.reciprocal(b) if b is width else div(a, b))
    assert E.bandwidth_detect(tab, torch.as_tensor(e_b))[0].tolist() == [4]


def _divisions_by_python_numbers(monkeypatch) -> list:
    """Patches Tensor's true division so that it records each division of a
    tensor by a Python number that is not a power of two, and each Python
    number divided by a tensor (a reciprocal times the number on either
    device); returns the list it appends to."""
    seen = []

    def pow2(c):
        return c != 0 and np.log2(abs(float(c))) == int(np.log2(abs(float(c))))

    def check(other, what):
        if isinstance(other, (int, float, np.number)) and not pow2(other):
            seen.append(what.format(other))

    div, rdiv, tdiv = torch.Tensor.__truediv__, torch.Tensor.__rtruediv__, torch.div

    def truediv(a, b):
        check(b, "t / {}")
        return div(a, b)

    def rtruediv(a, b):
        if isinstance(b, (int, float, np.number)):
            seen.append(f"{b} / t")
        return rdiv(a, b)

    def tdiv_(a, b, *args, **kw):
        check(b, "torch.div(t, {})")
        return tdiv(a, b, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "__truediv__", truediv)
    monkeypatch.setattr(torch.Tensor, "__rtruediv__", rtruediv)
    monkeypatch.setattr(torch, "div", tdiv_)
    return seen


@pytest.mark.parametrize("dur", [FrameDuration.MS10, FrameDuration.MS7P5], ids=["10ms", "7.5ms"])
@pytest.mark.parametrize("fs", [8000, 16000, 24000, 32000, 48000])
def test_encode_step_divides_by_no_python_number(monkeypatch, fs, dur):
    """A whole encode step on the CPU (the encoder's glue and every kernel's
    plain version) divides no tensor by a Python number that is not a power
    of two, and no Python number by a tensor: on a card either would be a
    reciprocal multiply, not the oracle's division."""
    cfg = Lc3Config.new(fs, dur)
    rng = np.random.default_rng(fs)
    x = (rng.standard_normal((2, cfg.nf)) * [[300.0], [3000.0]]).astype(np.int16)
    state = E.encoder_init(cfg, 2, "cpu")
    seen = _divisions_by_python_numbers(monkeypatch)
    for nbytes in (40, 150):
        state, _ = E.encode_step(cfg, nbytes, state, torch.as_tensor(x))
    assert not seen, sorted(set(seen))
