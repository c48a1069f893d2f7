"""Encoder TNS: the autocorrelation kernel (csrc/tns_autocorr.cu), the
analysis lattice kernel (csrc/tns_analysis.cu), and their plain PyTorch
versions.

- tns_autocorr replaces lc3jax/dsp/pallas_tns.py:tns_autocorr_pallas: for
  each of 2 filters x 3 sub-blocks the lag-0..8 sums of x[n] * x[n + k] over
  n in [lo, hi - k). Both versions sum in the oracle's order
  (lc3jax/ref/tns_enc.py:_autocorrelation), one strict left-to-right f32
  fold per lag; the JAX XLA and Pallas versions reduce with jnp.sum, whose
  order is XLA's.
- tns_analysis replaces lc3jax/dsp/pallas_tns.py:tns_analysis_pallas: the
  forward lattice (up to 2 filters of order <= 8) over the spectral lines,
  following the XLA scan of lc3jax/dsp/encoder.py:877-913.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from .. import _build


def _check(name, x, others):
    """x float32 [S, ne]; each (arg, tensor, shape, dtype) of others as given."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name}: x must be float32 [S, ne], got {x.dtype} {tuple(x.shape)}")
    for arg, t, shape, dtype in others:
        if t.device != x.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


# ----------------------------------------------------------- autocorrelation


def tns_autocorr_plain(x: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """x [S, ne] f32, sub [S, 2, 3, 2] int32 (lo, hi) -> [S, 2, 3, 9] f32."""
    S, ne = x.shape
    lo = sub[..., 0].reshape(S, 6).long()
    hi = sub[..., 1].reshape(S, 6).long()
    L = int((hi - lo).max()) if S else 0
    pos = lo[:, :, None] + torch.arange(L + 8, device=x.device)  # [S, 6, L + 8]
    xw = x.gather(1, pos.clamp(max=ne - 1).reshape(S, -1)).reshape(S, 6, L + 8)
    xw = torch.where(pos < hi[:, :, None], xw, 0.0)  # the window, zero past hi
    acc = torch.zeros(S, 6, 9, dtype=x.dtype, device=x.device)
    for j in range(L):  # the oracle's left-to-right fold, one add per line
        acc = acc + xw[:, :, j : j + 1] * xw[:, :, j : j + 9]
    return acc.reshape(S, 2, 3, 9)


def tns_autocorr(x: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """Masked lag sums for any S >= 1 (see tns_autocorr_plain).

    The kernel's device work is about 7 µs at S = 2048, so this wrapper is kept
    to what a PyTorch call costs on the host: attribute checks, one
    allocation and one launch through `_build.launch`, no conversion of
    inputs that need none."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return tns_autocorr_plain(x, sub)
        raise ValueError(f"tns_autocorr: unsupported device {x.device}")
    S, ne = x.shape
    index = x.get_device()
    if (x.dtype != torch.float32 or sub.dtype != torch.int32 or sub.shape != (S, 2, 3, 2)
            or sub.get_device() != index):
        raise ValueError(f"tns_autocorr: x must be float32 [S, ne] and sub int32 [S, 2, 3, 2] "
                         f"on {x.device}, got {x.dtype} {tuple(x.shape)}, {sub.dtype} "
                         f"{tuple(sub.shape)} on {sub.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not sub.is_contiguous():
        sub = sub.contiguous()
    out = x.new_empty((S, 2, 3, 9))  # x's type and device, without parsing them again
    _build.launch("lc3t_tns_autocorr", index, x.data_ptr(), sub.data_ptr(), out.data_ptr(), S, ne)
    return out


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
