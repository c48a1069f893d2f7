"""Inverse TNS: the CUDA kernel (csrc/tns_synthesis.cu) and its plain
PyTorch version.

Replaces lc3jax/dsp/pallas_tns.py:tns_synthesis_pallas; semantics of
lc3jax/dsp/decoder.py:tns_synthesis (an 8-tap IIR lattice over spectral
lines, up to two filters per frame). A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build


def _operands(tab, bandwidth, rc_order, rc_i):
    bounds = tab.tns_bounds[bandwidth.long()]  # [S, 4] lo0, hi0, lo1, hi1
    rc_q = tab.tns_sin[rc_i.long()]  # [S, 16]
    return bounds, rc_q, rc_order.to(torch.int32)


def tns_synthesis_plain(tab, x, bandwidth, rc_order, rc_i):
    """x [S, ne] f32 -> [S, ne]: the lattice line by line, vectorised over
    streams. Coefficients at or past a filter's order are zeroed, so a tap
    the reference skips subtracts an exact zero."""
    S, ne = x.shape
    bounds, rc_q, order = _operands(tab, bandwidth, rc_order, rc_i)
    n = torch.arange(ne, device=x.device)[:, None]  # [ne, 1]
    in_f0 = (n >= bounds[:, 0]) & (n < bounds[:, 1]) & (order[:, 0] > 0)
    in_f1 = (n >= bounds[:, 2]) & (n < bounds[:, 3]) & (order[:, 1] > 0)
    active = in_f0 | in_f1  # [ne, S]
    line_order = torch.where(in_f1, order[:, 1], order[:, 0])  # [ne, S]
    kk = torch.arange(8, device=x.device)
    rc = torch.where(in_f1[..., None], rc_q[None, :, 8:], rc_q[None, :, :8])  # [ne, S, 8]
    rc = torch.where(kk < line_order[..., None], rc, 0.0)
    upd = kk[:7] < (line_order[..., None] - 1)  # [ne, S, 7]
    kmax = int(line_order.max()) if ne else 0
    rows = active.any(dim=1).nonzero().flatten().tolist()

    out = x.clone()
    state = torch.zeros(S, 8, dtype=x.dtype, device=x.device)
    xt = x.t()
    for li in rows:
        r = rc[li]
        t = xt[li]
        ts = [t] * 8
        for k in range(kmax - 1, -1, -1):
            t = t - r[:, k] * state[:, k]
            ts[k] = t
        cand = r[:, :7] * torch.stack(ts[:7], 1) + state[:, :7]
        new_state = torch.cat([t[:, None], torch.where(upd[li], cand, state[:, 1:])], 1)
        a = active[li]
        state = torch.where(a[:, None], new_state, state)
        out[:, li] = torch.where(a, t, xt[li])
    return out


def tns_synthesis(tab, x, bandwidth, rc_order, rc_i):
    """Inverse TNS, x [S, ne] f32 -> [S, ne] contiguous, for any S >= 1.

    The kernel reads x, the parsed fields and the two tables as they are,
    and looks up each stream's filter bounds and coefficients itself."""
    if x.device.type == "cpu":
        return tns_synthesis_plain(tab, x, bandwidth, rc_order, rc_i)
    if x.device.type != "cuda":
        raise ValueError(f"tns_synthesis: unsupported device {x.device}")
    S, ne = x.shape
    if x.dtype != torch.float32:
        raise ValueError(f"tns_synthesis: x must be float32, got {x.dtype}")
    operands = []
    for name, t, shape, dtype in (("bandwidth", bandwidth, (S,), torch.int32),
                                  ("rc_order", rc_order, (S, 2), torch.int32),
                                  ("rc_i", rc_i, (S, 16), torch.int32),
                                  ("tab.tns_bounds", tab.tns_bounds, (5, 4), torch.int32),
                                  ("tab.tns_sin", tab.tns_sin, (17,), torch.float32)):
        if t.device != x.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"tns_synthesis: {name} must be {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        operands.append(t if t.is_contiguous() else t.contiguous())
    if not x.is_contiguous():
        x = x.contiguous()
    out = x.new_empty((S, ne))
    _build.launch("lc3t_tns_synthesis", x.get_device(), x.data_ptr(),
                  *[t.data_ptr() for t in operands], out.data_ptr(), S, ne)
    return out
