"""lc3jax_torch inverse TNS (plain version) against the JAX lattice and the
oracle.

On the CPU, XLA contracts the lattice's multiply-adds into fma; eager
PyTorch (and the CUDA kernel, built with --fmad=false) rounds each op. So
the port is held bit for bit against an f32 scalar evaluation of the JAX
update rule without contraction, JAX against the same evaluation with fma,
and the two packages against each other on decoded content, where the
difference (measured 3.1e-5 at an output scale of 19542 on stream50) stays
within 1 ulp of the output scale. On random 8th-order lattices the
recursion amplifies the contraction: 0.036 at an output scale of 23019.
"""

import jax
import numpy as np
import pytest
import torch

from lc3jax.config import FrameDuration as JFrameDuration
from lc3jax.config import Lc3Config as JLc3Config
from lc3jax.dsp import decoder as JD
from lc3jax.dsp.params import decoder_params
from lc3jax_torch import _build
from lc3jax_torch.coding.device import device_parse_plain
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import decoder_tables, tns_sin_table
from lc3jax_torch.dsp import decoder as TD
from lc3jax_torch.dsp import tns_kernel
from lc3jax_torch.dsp.tns_kernel import tns_synthesis, tns_synthesis_plain

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
J48 = JLc3Config.new(48000, JFrameDuration.MS10)
F32 = np.float32


def _random_case(S=8, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((S, CFG48.ne)) * 1000).astype(F32)
    bw = rng.integers(0, 5, S).astype(np.int32)
    rc_order = np.stack([rng.integers(0, 9, S), rng.integers(0, 9, S)], 1).astype(np.int32)
    rc_i = rng.integers(0, 17, (S, 16)).astype(np.int32)
    return x, bw, rc_order, rc_i


def _scalar_lattice(x, bw, rc_order, rc_i, fma: bool):
    """The update rule of lc3jax/dsp/decoder.py:tns_synthesis, one f32
    scalar op at a time (optionally with fused multiply-adds)."""
    p = decoder_params(J48)
    sin = tns_sin_table()
    if fma:
        mac = lambda a, b, c: F32(np.float64(a) * np.float64(b) + np.float64(c))
    else:
        mac = lambda a, b, c: F32(F32(a * b) + c)
    out = x.copy()
    for s in range(x.shape[0]):
        b = p.tns_filter_bounds[bw[s]]
        st = [F32(0)] * 8
        for n in range(x.shape[1]):
            f0 = b[0, 0] <= n < b[0, 1] and rc_order[s, 0] > 0
            f1 = b[1, 0] <= n < b[1, 1] and rc_order[s, 1] > 0
            if not (f0 or f1):
                continue
            order = rc_order[s, 1] if f1 else rc_order[s, 0]
            rc = [sin[rc_i[s, (8 if f1 else 0) + k]] for k in range(8)]
            t, ns = x[s, n], list(st)
            for kk in range(7, -1, -1):
                if kk < order:
                    t = mac(-rc[kk], st[kk], t)
                if kk < 7:
                    ns[kk + 1] = mac(rc[kk], t, st[kk]) if kk < order - 1 else st[kk + 1]
            ns[0] = t
            st = ns
            out[s, n] = t
    return out


def _plain(x, bw, rc_order, rc_i, nbits=1200):
    tab = decoder_tables(CFG48, nbits)
    t = lambda a: torch.as_tensor(a)
    return tns_synthesis_plain(tab, t(x), t(bw), t(rc_order), t(rc_i)).numpy()


@pytest.mark.parametrize("fma", [False, True], ids=["port", "jax"])
def test_tns_bit_exact_against_scalar_lattice(fma):
    x, bw, ro, ri = _random_case()
    want = _scalar_lattice(x, bw, ro, ri, fma=fma)
    if fma:
        got = np.asarray(JD.tns_synthesis(decoder_params(J48), x, bw, ro, ri))
    else:
        got = _plain(x, bw, ro, ri)
    assert np.array_equal(got, want)


def test_tns_plain_matches_jax_on_decoded_frames(goldens):
    g = goldens("stream50")
    fr = device_parse_plain(CFG48, 120, torch.as_tensor(g["payloads"]))
    tab = decoder_tables(CFG48, 960)
    x = TD.pre_tns(tab, fr)
    got = tns_synthesis_plain(tab, x, fr.bandwidth, fr.rc_order, fr.rc_i).numpy()
    ref = np.asarray(JD.tns_synthesis(decoder_params(J48), x.numpy(), fr.bandwidth.numpy(),
                                      fr.rc_order.numpy(), fr.rc_i.numpy()))
    assert int(fr.rc_order.max()) > 0, "content exercises no TNS filter"
    assert np.abs(got - ref).max() <= np.spacing(F32(np.abs(ref).max()))


def test_tns_matches_oracle_golden(goldens):
    g = goldens("tns_decode")
    rc_i = np.zeros((1, 16), np.int32)
    rc_i[0, :8] = [6, 10, 7, 8, 7, 9, 7, 7]
    got = _plain(g["x"][None].astype(F32), np.array([4], np.int32),
                 np.array([[8, 0]], np.int32), rc_i)
    assert np.array_equal(got[0], g["expected"])


def test_tns_wrapper_takes_plain_for_cpu_and_refuses_other_devices():
    x, bw, ro, ri = _random_case(S=3, seed=4)
    tab = decoder_tables(CFG48, 1200)
    t = lambda a: torch.as_tensor(a)
    before = _build.launches.copy()
    got = tns_synthesis(tab, t(x), t(bw), t(ro), t(ri))
    assert _build.launches == before
    assert torch.equal(got, tns_synthesis_plain(tab, t(x), t(bw), t(ro), t(ri)))
    with pytest.raises(ValueError, match="unsupported device"):
        tns_synthesis(tab, t(x).to("meta"), t(bw), t(ro), t(ri))
