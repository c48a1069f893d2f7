"""The spectral bit model's table part: the CUDA kernel (csrc/bitmodel.cu)
and its plain PyTorch version.

Replaces lc3jax/dsp/pallas_bitmodel.py:bitmodel_table_part, with and without
emit_pack; semantics of lc3jax/dsp/encoder.py:bit_consumption (:1189-1261).
For each spectral tuple n with context c, escape-ladder depth g and final
symbol sym, the arithmetic coder's cost in 1/2048 bits of the escapes and
the final symbol:

    pki_L = AC_SPEC_LOOKUP[c + rate_flag + 256 * (n > ne / 4) + 1024 * L]
    bits  = sum_{L < min(g, 3)} AC_SPEC_BITS[pki_L, 16]
          + max(g - 3, 0) * AC_SPEC_BITS[pki_3, 16]
          + AC_SPEC_BITS[pki_min(g, 3), sym]

With emit_pack it also returns the range coder's operands for the same
tuples, int32 [5 * NT, S] (stream-minor, the layout the pack kernel reads):
row L * NT + n holds cum + 1024 * freq of the escape symbol at ladder level
L = 0..3 (AC_SPEC_CUMFREQ/FREQ[pki_L, 16]), row 4 * NT + n that of the final
symbol (AC_SPEC_CUMFREQ/FREQ[pki_min(g, 3), sym]). The JAX kernel padded the
rows to a multiple of 8 (TPU tiling); `convert.pack_tables_from_jax` drops
that pad.

The TPU kernel fetched the tables with one-hot matmuls on the MXU, its
workaround for gathers; here they are plain lookups. The result is exact
integers (int32). A tuple at or past the stream's own (lastnz + 1) >> 1
holds 0 in both versions, in every output: the tail masks its cost and the
pack kernel never reads its operands.

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
emit_launches = 0  # of those, the launches with emit_pack


@lru_cache(maxsize=None)
def tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(AC_SPEC_LOOKUP int32 [4096], AC_SPEC_BITS int32 [64, 17]) on device."""
    return (torch.as_tensor(np.asarray(T.AC_SPEC_LOOKUP, np.int32), device=device),
            torch.as_tensor(np.asarray(T.AC_SPEC_BITS, np.int32), device=device))


@lru_cache(maxsize=None)
def coder_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(AC_SPEC_CUMFREQ, AC_SPEC_FREQ), int32 [64, 17] on device: emit_pack's."""
    return (torch.as_tensor(np.asarray(T.AC_SPEC_CUMFREQ, np.int32), device=device),
            torch.as_tensor(np.asarray(T.AC_SPEC_FREQ, np.int32), device=device))


def bitmodel_table_part_plain(c, g, sym, rate_flag: int, ne: int, lastnz,
                              emit_pack: bool = False):
    """c, g, sym [S, NT] int32; lastnz [S] int32 -> int32 [S, NT], and with
    emit_pack also int32 [5 * NT, S]."""
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
    coded = n[None, :] < ((lastnz.long() + 1) >> 1)[:, None]
    est = torch.where(coded, est, 0).to(torch.int32)
    if not emit_pack:
        return est
    cum, frq = coder_tables(c.device)
    rows = [cum[p, 16] + 1024 * frq[p, 16] for p in pki]
    rows.append(cum[pki_fin, sym.long()] + 1024 * frq[pki_fin, sym.long()])
    pk = torch.cat([torch.where(coded, r, 0).t() for r in rows], dim=0)
    return est, pk.to(torch.int32).contiguous()


def bitmodel_table_part(c, g, sym, rate_flag: int, ne: int, lastnz, emit_pack: bool = False):
    """Per-tuple table bits for any S >= 1 (see bitmodel_table_part_plain)."""
    if c.device.type == "cpu":
        return bitmodel_table_part_plain(c, g, sym, rate_flag, ne, lastnz, emit_pack)
    if c.device.type != "cuda":
        raise ValueError(f"bitmodel_table_part: unsupported device {c.device}")
    S, NT = c.shape
    for name, t, shape in (("c", c, (S, NT)), ("g", g, (S, NT)), ("sym", sym, (S, NT)),
                           ("lastnz", lastnz, (S,))):
        if t.device != c.device or tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"bitmodel_table_part: {name} must be int32 {shape} on {c.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    global launches, emit_launches
    # the contiguous views stay bound to names until the launch is queued
    c32, g32, sym32, lnz32 = (t.contiguous() for t in (c, g, sym, lastnz))
    lut, bits = tables(c.device)
    cum, frq = coder_tables(c.device)
    out = c32.new_empty((S, NT))
    pk = c32.new_empty((5 * NT, S)) if emit_pack else None
    _build.launch("lc3t_bitmodel", c.get_device(), c32.data_ptr(), g32.data_ptr(),
                  sym32.data_ptr(), lnz32.data_ptr(), lut.data_ptr(), bits.data_ptr(),
                  cum.data_ptr(), frq.data_ptr(), out.data_ptr(),
                  pk.data_ptr() if emit_pack else None, S, NT, ne // 4, rate_flag)
    launches += 1
    if emit_pack:
        emit_launches += 1
        return out, pk
    return out
