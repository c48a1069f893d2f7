"""Encoder TNS: the coefficient kernel (csrc/tns_coefficients.cu), the
analysis lattice kernel (csrc/tns_analysis.cu), and their plain PyTorch
versions.

- tns_coefficients replaces lc3jax/dsp/pallas_tns.py:tns_autocorr_pallas
  and the XLA glue after it (lc3jax/dsp/encoder.py:705-871): for each
  stream, the lag-0..8 sums of x[n] * x[n + k] over n in [lo, hi - k) of
  its 2 filters x 3 sub-blocks, then per filter the normalised, windowed
  autocorrelation, Levinson-Durbin, the prediction-gain gate, the LPC
  weighting, the reflection coefficients, their quantisation and the bit
  budget (lc3jax/ref/tns_enc.py:60-200). Each lag sum is the oracle's
  strict left-to-right f32 fold (ref/tns_enc.py:_autocorrelation); the JAX
  XLA and Pallas versions reduce with jnp.sum, whose order is XLA's.
- tns_analysis replaces lc3jax/dsp/pallas_tns.py:tns_analysis_pallas: the
  forward lattice (up to 2 filters of order <= 8) over the spectral lines,
  following the XLA scan of lc3jax/dsp/encoder.py:877-913.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build, fp

I32 = torch.int32
ONE_MINUS_085 = float(np.float32(1.0) - np.float32(0.85))


def _check(name, x, others):
    """x float32 [S, ne]; each (arg, tensor, shape, dtype) of others as given."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name}: x must be float32 [S, ne], got {x.dtype} {tuple(x.shape)}")
    for arg, t, shape, dtype in others:
        if t.device != x.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


# ------------------------------------------------------ TNS coefficients


def tns_autocorr_plain(x: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """x [S, ne] f32, sub [S, 2, 3, 2] int32 (lo, hi) -> [S, 2, 3, 9] f32;
    a bound past ne stops at ne, as the oracle's slices do."""
    S, ne = x.shape
    hi = sub[..., 1].reshape(S, 6).long().clamp(max=ne)
    lo = torch.minimum(sub[..., 0].reshape(S, 6).long(), hi)
    L = int((hi - lo).max()) if S else 0
    pos = lo[:, :, None] + torch.arange(L + 8, device=x.device)  # [S, 6, L + 8]
    xw = x.gather(1, pos.clamp(max=ne - 1).reshape(S, -1)).reshape(S, 6, L + 8)
    xw = torch.where(pos < hi[:, :, None], xw, 0.0)  # the window, zero past hi
    acc = torch.zeros(S, 6, 9, dtype=x.dtype, device=x.device)
    for j in range(L):  # the oracle's left-to-right fold, one add per line
        acc = acc + xw[:, :, j : j + 1] * xw[:, :, j : j + 9]
    return acc.reshape(S, 2, 3, 9)


def _powi(x, n: int):
    """f32 x^n by binary exponentiation (LLVM powi, ref/tns_enc.py:_powi)."""
    result = torch.ones_like(x)
    base = x
    while n > 0:
        if n & 1:
            result = result * base
        base = base * base
        n >>= 1
    return result


def tns_lpc_plain(tab, ac, near_nyquist, lpc_weighting: int):
    """ac [S, 2, 3, 9] lag sums -> (rc [S, 2, 8] f32, the reflection
    coefficients, zero where the prediction-gain gate is off; pred_gain
    [S, 2] f32). ref/tns_enc.py:140-200."""
    S = ac.shape[0]
    dev = ac.device
    rcs, gains = [], []
    for f in range(2):
        es = ac[:, f, :, 0]  # [S, 3]
        e_prod = (es[:, 0] * es[:, 1]) * es[:, 2]
        ok = es != 0.0
        rs = []
        for k in range(9):
            q = torch.where(ok, ac[:, f, :, k] / es, 0.0)
            rk = (q[:, 0] + q[:, 1]) + q[:, 2]
            r0 = 3.0 if k == 0 else 0.0
            rs.append(torch.where(e_prod == 0.0, r0, rk) * tab.lag_window[k])
        r = torch.stack(rs, 1)  # [S, 9]

        # Levinson-Durbin (ref/tns_enc.py:161-176)
        a = [torch.ones(S, device=dev)] + [torch.zeros(S, device=dev)] * 8
        e = r[:, 0]
        for k in range(1, 9):
            rc = torch.zeros(S, device=dev)
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
                            1.0 - (ONE_MINUS_085 * (2.0 - pred_gain)) / 0.5,
                            torch.ones_like(pred_gain))
        a = [a[k] * _powi(gamma, k) for k in range(9)]

        # LPC -> reflection coefficients (inverse recursion)
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
        rcs.append(torch.where(on[:, None], torch.stack(rc_f, 1), 0.0))
        gains.append(pred_gain)
    return torch.stack(rcs, 1), torch.stack(gains, 1)


def tns_quantise_plain(tab, rc):
    """rc f32 [...] -> its index rc_i, int64: round(asinf(rc) / (pi/17)),
    halves away from zero, + 8 (ref/tns_enc.py:80-86). tab.tns_step is a
    device tensor: a Python float would divide on a card as a reciprocal
    multiply, which takes rc = 0.9829731 to 16 where the oracle has 15."""
    q = fp.asinf(rc) / tab.tns_step
    qi = torch.where(q >= 0.0, (q + 0.5).to(torch.int64), -((-q + 0.5).to(torch.int64)))
    return qi + 8


def tns_coefficients_plain(tab, x, bw_ind, near_nyquist, lpc_weighting: int):
    """x [S, ne] f32, bw_ind [S] int32, near_nyquist [S] bool ->
    (ac [S, 2, 3, 9] f32, rc_i [S, 16] int32, rc_q [S, 16] f32,
    rc_order [S, 2] int32, nbits_tns [S] int32); a filter the bandwidth
    does not have (f >= num_filters) gets rc_i 8, rc_q 0 and order 0."""
    S = x.shape[0]
    dev = x.device
    bw = bw_ind.long()
    num_filters = torch.where(bw >= 3, 2, 1)
    ac = tns_autocorr_plain(x, tab.tns_sub[bw])
    rc, _ = tns_lpc_plain(tab, ac, near_nyquist, lpc_weighting)

    rc_q = torch.zeros(S, 16, dtype=torch.float32, device=dev)
    rc_i = torch.full((S, 16), 8, dtype=torch.int64, device=dev)
    rc_order = torch.zeros(S, 2, dtype=I32, device=dev)
    k8 = torch.arange(1, 9, device=dev)
    for f in range(2):
        rci_f = tns_quantise_plain(tab, rc[:, f])
        rcq_f = tab.tns_sin[rci_f.clamp(0, 16)]
        order = torch.where(rci_f != 8, k8, 0).amax(1)  # highest k with rc_i != 8
        exists = f < num_filters
        rc_i[:, 8 * f : 8 * f + 8] = torch.where(exists[:, None], rci_f, 8)
        rc_q[:, 8 * f : 8 * f + 8] = torch.where(exists[:, None], rcq_f, 0.0)
        rc_order[:, f] = torch.where(exists, order, 0)

    # bit budget from the arithmetic coder's table costs
    order_bits, coef_bits = tab.tns_bits[:16].view(2, 8), tab.tns_bits[16:].view(8, 17)
    nbits_tns = torch.zeros(S, dtype=torch.int64, device=dev)
    ks = torch.arange(8, device=dev)
    for f in range(2):
        o = rc_order[:, f]
        nb_order = torch.where(o > 0, order_bits[lpc_weighting][(o - 1).clamp(min=0)], 0)
        per_k = coef_bits[ks[None, :], rc_i[:, 8 * f : 8 * f + 8]]  # [S, 8]
        nb_coef = torch.where(ks[None, :] < o[:, None], per_k, 0).sum(1)
        add = torch.ceil((2048.0 + nb_order.float() + nb_coef.float()) / 2048.0).long()
        nbits_tns = nbits_tns + torch.where(f < num_filters, add, 0)
    return ac, rc_i.to(I32), rc_q, rc_order, nbits_tns.to(I32)


def tns_coefficients(tab, x, bw_ind, near_nyquist, lpc_weighting: int):
    """TNS coefficients for any S >= 1 (see tns_coefficients_plain). On the
    card the kernel reads x, bw_ind, near_nyquist and the encoder tables
    (tab: tns_sub, lag_window, tns_sin, tns_bits, tns_step) as they are and
    looks each stream's sub-blocks up itself; the wrapper checks attributes,
    allocates the five outputs and launches."""
    if x.device.type == "cpu":
        return tns_coefficients_plain(tab, x, bw_ind, near_nyquist, lpc_weighting)
    if x.device.type != "cuda":
        raise ValueError(f"tns_coefficients: unsupported device {x.device}")
    S, ne = x.shape
    _check("tns_coefficients", x, [("bw_ind", bw_ind, (S,), I32),
                                   ("near_nyquist", near_nyquist, (S,), torch.bool),
                                   ("tab.tns_sub", tab.tns_sub, (5, 2, 3, 2), I32),
                                   ("tab.lag_window", tab.lag_window, (9,), torch.float32),
                                   ("tab.tns_sin", tab.tns_sin, (17,), torch.float32),
                                   ("tab.tns_bits", tab.tns_bits, (152,), I32),
                                   ("tab.tns_step", tab.tns_step, (), torch.float32)])
    if lpc_weighting not in (0, 1):
        raise ValueError(f"tns_coefficients: lpc_weighting must be 0 or 1, got {lpc_weighting}")
    args = [t if t.is_contiguous() else t.contiguous() for t in (x, bw_ind, near_nyquist)]
    ac = x.new_empty((S, 2, 3, 9))
    rc_i = bw_ind.new_empty((S, 16))
    rc_q = x.new_empty((S, 16))
    rc_order = bw_ind.new_empty((S, 2))
    nbits_tns = bw_ind.new_empty((S,))
    outs = (ac, rc_i, rc_q, rc_order, nbits_tns)
    _build.launch("lc3t_tns_coefficients", x.get_device(), *[t.data_ptr() for t in args],
                  *[t.data_ptr() for t in (tab.tns_sub, tab.lag_window, tab.tns_sin,
                                           tab.tns_bits, tab.tns_step)],
                  *[t.data_ptr() for t in outs], S, ne, lpc_weighting)
    return outs


# ---------------------------------------------------------- analysis lattice


def _orders(rc_order, num_filters):
    # the num_filters > 1 gate folds into the second filter's order
    ord1 = torch.where(num_filters > 1, rc_order[:, 1], 0)
    return torch.stack([rc_order[:, 0], ord1], 1).to(torch.int32)


def tns_analysis_plain(x, bounds, rc_order, num_filters, rc_q):
    """x [S, ne] f32; bounds [S, 2, 2] (lo, hi) per filter, rc_order [S, 2]
    and num_filters [S], int32; rc_q [S, 16] f32 -> the filtered x [S, ne]."""
    S, ne = x.shape
    dev = x.device
    order = _orders(rc_order, num_filters).long()
    b = bounds.reshape(S, 4).long()
    n = torch.arange(ne, device=dev)[:, None]  # [ne, 1]
    in_f0 = (n >= b[:, 0]) & (n < b[:, 1]) & (order[:, 0] > 0)
    in_f1 = (n >= b[:, 2]) & (n < b[:, 3]) & (order[:, 1] > 0)
    active = in_f0 | in_f1  # [ne, S]
    line_order = torch.where(in_f1, order[:, 1], order[:, 0])  # [ne, S]
    rows = active.any(dim=1).nonzero().flatten().tolist()
    rc0, rc1 = rc_q[:, :8], rc_q[:, 8:]
    kk8 = torch.arange(8, device=dev)

    out = x.clone()
    st = torch.zeros(S, 8, dtype=x.dtype, device=dev)
    for li in rows:
        a = active[li]
        o = line_order[li]
        rc = torch.where(in_f1[li][:, None], rc1, rc0)
        xn = x[:, li]
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
        out[:, li] = torch.where(a, t, xn)
    return out


def tns_analysis(x, bounds, rc_order, num_filters, rc_q):
    """Forward TNS lattice for any S >= 1 (see tns_analysis_plain); on the
    card the kernel reads every input as it is and gates the second filter
    by num_filters itself, and the result is a contiguous [S, ne]."""
    if x.device.type == "cpu":
        return tns_analysis_plain(x, bounds, rc_order, num_filters, rc_q)
    if x.device.type != "cuda":
        raise ValueError(f"tns_analysis: unsupported device {x.device}")
    S, ne = x.shape
    i32 = torch.int32
    _check("tns_analysis", x, [("bounds", bounds, (S, 2, 2), i32),
                               ("rc_order", rc_order, (S, 2), i32),
                               ("num_filters", num_filters, (S,), i32),
                               ("rc_q", rc_q, (S, 16), torch.float32)])
    args = [t if t.is_contiguous() else t.contiguous()
            for t in (x, bounds, rc_order, num_filters, rc_q)]
    out = x.new_empty((S, ne))
    _build.launch("lc3t_tns_analysis", x.get_device(), *[t.data_ptr() for t in args],
                  out.data_ptr(), S, ne)
    return out
