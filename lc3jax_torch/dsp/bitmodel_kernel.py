"""The spectral bit model's table part: the CUDA kernel (csrc/bitmodel.cu)
and its plain PyTorch version.

Replaces lc3jax/dsp/pallas_bitmodel.py:bitmodel_table_part (without
emit_pack); semantics of lc3jax/dsp/encoder.py:bit_consumption (:1189-1231).
For each spectral tuple n with context c, escape-ladder depth g and final
symbol sym, the arithmetic coder's cost in 1/2048 bits of the escapes and
the final symbol:

    pki_L = AC_SPEC_LOOKUP[c + rate_flag + 256 * (n > ne / 4) + 1024 * L]
    bits  = sum_{L < min(g, 3)} AC_SPEC_BITS[pki_L, 16]
          + max(g - 3, 0) * AC_SPEC_BITS[pki_3, 16]
          + AC_SPEC_BITS[pki_min(g, 3), sym]

The TPU kernel fetched the tables with one-hot matmuls on the MXU, its
workaround for gathers; here they are plain lookups. The result is exact
integers (int32). A tuple at or past the stream's own (lastnz + 1) >> 1
holds 0 in both versions: the tail masks it anyway.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .. import tables as T

launches = 0  # kernel launches since the last reset


@lru_cache(maxsize=None)
def tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(AC_SPEC_LOOKUP int32 [4096], AC_SPEC_BITS int32 [64, 17]) on device."""
    return (torch.as_tensor(np.asarray(T.AC_SPEC_LOOKUP, np.int32), device=device),
            torch.as_tensor(np.asarray(T.AC_SPEC_BITS, np.int32), device=device))


def bitmodel_table_part_plain(c, g, sym, rate_flag: int, ne: int, lastnz):
    """c, g, sym [S, NT] int32; lastnz [S] int32 -> int32 [S, NT]."""
    S, NT = c.shape
    lut, bits = tables(c.device)
    n = torch.arange(NT, device=c.device)
    base = c.long() + rate_flag + torch.where(n > ne // 4, 256, 0)[None, :]
    pki = [lut[base + 1024 * L].long() for L in range(4)]
    esc = [bits[p, 16] for p in pki]
    g = g.long()
    est = (torch.where(g > 0, esc[0], 0) + torch.where(g > 1, esc[1], 0)
           + torch.where(g > 2, esc[2], 0) + (g - 3).clamp(min=0) * esc[3])
    lev = g.clamp(max=3)
    pki_fin = torch.where(lev == 0, pki[0], torch.where(lev == 1, pki[1],
                          torch.where(lev == 2, pki[2], pki[3])))
    est = est + bits[pki_fin, sym.long()]
    n_tuples = (lastnz.long() + 1) >> 1
    return torch.where(n[None, :] < n_tuples[:, None], est, 0).to(torch.int32)


def bitmodel_table_part(c, g, sym, rate_flag: int, ne: int, lastnz):
    """Per-tuple table bits for any S >= 1 (see bitmodel_table_part_plain)."""
    if c.device.type == "cpu":
        return bitmodel_table_part_plain(c, g, sym, rate_flag, ne, lastnz)
    if c.device.type != "cuda":
        raise ValueError(f"bitmodel_table_part: unsupported device {c.device}")
    S, NT = c.shape
    for name, t, shape in (("c", c, (S, NT)), ("g", g, (S, NT)), ("sym", sym, (S, NT)),
                           ("lastnz", lastnz, (S,))):
        if t.device != c.device or tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"bitmodel_table_part: {name} must be int32 {shape} on {c.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    global launches
    # the contiguous views stay bound to names until the launch is queued
    c32, g32, sym32, lnz32 = (t.contiguous() for t in (c, g, sym, lastnz))
    lut, bits = tables(c.device)
    out = torch.empty(S, NT, dtype=torch.int32, device=c.device)
    with torch.cuda.device(c.device):
        err = _build.lib().lc3t_bitmodel(
            c32.data_ptr(), g32.data_ptr(), sym32.data_ptr(), lnz32.data_ptr(),
            lut.data_ptr(), bits.data_ptr(), out.data_ptr(), S, NT, ne // 4, rate_flag,
            _build.stream_ptr(c.device),
        )
    _build.check(err, "lc3t_bitmodel")
    launches += 1
    return out
