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
workaround for gathers; here they are plain lookups. Like the TPU kernel's
`_bitmodel_tables`, the CUDA kernel reads tables precomposed for the
launch's rate flag (`compose_tables`, exact integer numpy), so a tuple costs
one lookup per ladder level and one for its symbol. The result is exact
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


# Offsets of the precomposed tables in compose_tables' buffer (csrc/bitmodel.cu)
ESC_WORD, SYM_COST, ESC_OP, SYM_OP, TABLE_WORDS = 0, 2048, 3136, 5184, 6272


def compose_tables(rate_flag: int) -> np.ndarray:
    """The CUDA kernel's tables for one rate flag, int32 [6272], exact:
    ESC_WORD + (hi * 4 + L) * 256 + c: pki | AC_SPEC_BITS[pki, 16] << 6, where
    pki = AC_SPEC_LOOKUP[c + rate_flag + 256 * hi + 1024 * L];
    SYM_COST + 17 * pki + sym: AC_SPEC_BITS[pki, sym];
    ESC_OP + (hi * 4 + L) * 256 + c: CUMFREQ[pki, 16] + 1024 * FREQ[pki, 16];
    SYM_OP + 17 * pki + sym: CUMFREQ[pki, sym] + 1024 * FREQ[pki, sym]."""
    lut = np.asarray(T.AC_SPEC_LOOKUP, np.int64)
    bits = np.asarray(T.AC_SPEC_BITS, np.int64)
    op = np.asarray(T.AC_SPEC_CUMFREQ, np.int64) + 1024 * np.asarray(T.AC_SPEC_FREQ, np.int64)
    hl = np.arange(8)[:, None]  # row hi * 4 + L
    pki = lut[np.arange(256)[None, :] + rate_flag + 256 * (hl // 4) + 1024 * (hl % 4)]
    out = np.concatenate([(pki + (bits[pki, 16] << 6)).ravel(), bits.ravel(),
                          op[pki, 16].ravel(), op.ravel()])
    assert out.shape == (TABLE_WORDS,) and 0 <= out.min() and out.max() < 2**31
    return out.astype(np.int32)


@lru_cache(maxsize=None)
def composed_tables(device: torch.device, rate_flag: int) -> torch.Tensor:
    """compose_tables(rate_flag) on device."""
    return torch.as_tensor(compose_tables(rate_flag), device=device)


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
    # the contiguous views stay bound to names until the launch is queued
    c32, g32, sym32, lnz32 = (t.contiguous() for t in (c, g, sym, lastnz))
    tab = composed_tables(c.device, rate_flag)
    out = c32.new_empty((S, NT))
    pk = c32.new_empty((5 * NT, S)) if emit_pack else None
    _build.launch("lc3t_bitmodel", c.get_device(), c32.data_ptr(), g32.data_ptr(),
                  sym32.data_ptr(), lnz32.data_ptr(), tab.data_ptr(), out.data_ptr(),
                  pk.data_ptr() if emit_pack else None, S, NT, ne // 4,
                  tag="emit_pack" if emit_pack else None)
    if emit_pack:
        return out, pk
    return out
