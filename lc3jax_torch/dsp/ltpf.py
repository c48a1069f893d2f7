"""Batched LTPF synthesis filter (port of lc3jax/dsp/ltpf.py).

The post filter is an IIR whose denominator taps read the filter output
pitch_int - l_den/2 samples back; since pitch_int >= 18 for every config,
samples are produced in blocks of B <= 16 with no intra-block dependency.
The five transition cases (inactive / fade-in / fade-out / steady /
pitch-change) are two masked passes over the frame: pass A is the fade-out
signal (cases 3 and 5), pass B the final output, reading pass A's output
for case 5's fade-in. Both passes run in one call of
`ltpf_kernel.ltpf_both_passes`: the CUDA kernel for a CUDA tensor, its
plain PyTorch version (built on `_fir` and `_blocked_filter_pass` below)
for a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch


@dataclass
class LtpfState:
    hist_x: torch.Tensor  # f32 [S, H] last H filter inputs
    hist_y: torch.Tensor  # f32 [S, H] last H filter outputs
    c_num: torch.Tensor  # f32 [S, l_num + 1]
    c_den: torch.Tensor  # f32 [S, l_den + 1]
    p_int: torch.Tensor  # int32 [S]
    p_fr: torch.Tensor  # int32 [S]
    active: torch.Tensor  # bool [S]


def ltpf_init(p, n_streams: int, device="cpu") -> LtpfState:
    H = p.num_mem_blocks * p.nf
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return LtpfState(
        hist_x=z(n_streams, H),
        hist_y=z(n_streams, H),
        c_num=z(n_streams, p.l_num + 1),
        c_den=z(n_streams, p.l_den + 1),
        p_int=torch.zeros(n_streams, dtype=torch.int32, device=device),
        p_fr=torch.zeros(n_streams, dtype=torch.int32, device=device),
        active=torch.zeros(n_streams, dtype=torch.bool, device=device),
    )


def _gains(p, nbits: int) -> tuple[float, int]:
    """(gain_ltpf, gain_ind), static per frame size."""
    if p.cfg.n_ms.value == "7.5ms":
        t_nbits = int(np.floor(nbits * 10.0 / 7.5 + 0.5))
    else:
        t_nbits = nbits
    base = p.cfg.fs_ind * 80
    for thresh, gain, ind in ((320, 0.4, 0), (400, 0.35, 1), (480, 0.3, 2), (560, 0.25, 3)):
        if t_nbits < thresh + base:
            return gain, ind
    return 0.0, 0


def _filter_params(p, pitch_index):
    """pitch_index [S] -> (p_int, p_fr) at the output rate; exact in f32."""
    pi = pitch_index
    int_hi = pi - 283
    int_mid = pi // 2 - 63
    fr_mid = 2 * pi - 4 * int_mid - 252
    int_lo = pi // 4 + 32
    fr_lo = pi + 128 - 4 * int_lo
    p12 = torch.where(pi >= 440, int_hi, torch.where(pi >= 380, int_mid, int_lo))
    f12 = torch.where(pi >= 440, 0, torch.where(pi >= 380, fr_mid, fr_lo))
    pitch = p12.to(torch.float32) + f12.to(torch.float32) / 4.0
    p_up = (pitch * float(p.pitch_scale) * 4.0 + 0.5).to(torch.int32)
    return p_up // 4, p_up - 4 * (p_up // 4)


def _reach_back(p) -> int:
    """Max denominator reach-back: the largest p_int over every value of the
    9-bit pitch index, plus ceil(l_den / 2). Computed once per (pitch
    scale, l_den), so that a decode step reads no tensor on the host."""
    return _reach_back_of(float(p.pitch_scale), p.l_den)


@lru_cache(maxsize=None)
def _reach_back_of(pitch_scale: float, l_den: int) -> int:
    p_int, _ = _filter_params(SimpleNamespace(pitch_scale=pitch_scale),
                              torch.arange(1 << 9, dtype=torch.int32))
    return int(p_int.max()) + (l_den - l_den // 2)


def ltpf_run(tab, st: LtpfState, x, nbits: int, active, pitch_index):
    """One batched LTPF frame: (state, x [S, nf]) -> (y [S, nf], state).

    `tab` is the convert.DecoderTables of (config, nbits, device)."""
    from .ltpf_kernel import ltpf_both_passes

    nf = tab.p.nf
    args, (p_int, p_fr, c_num, c_den), (case_inactive, case_fade_out) = ltpf_pass_args(
        tab, st, x, active, pitch_index)
    yA, yB = ltpf_both_passes(*args)
    y = torch.where(case_inactive[:, None], x, yB)
    y = torch.where(case_fade_out[:, None], torch.where(tab.in_fade[None, :], yA, x), y)
    new_state = LtpfState(
        hist_x=args[1][:, nf:],
        hist_y=torch.cat([st.hist_y[:, nf:], y], dim=1),  # contiguous, as the kernel takes it
        c_num=c_num,
        c_den=c_den,
        p_int=p_int,
        p_fr=p_fr,
        active=active,
    )
    return y, new_state


def ltpf_pass_args(tab, st: LtpfState, x, active, pitch_index):
    """One frame's transition cases -> (the arguments of ltpf_both_passes,
    the new (p_int, p_fr, c_num, c_den), (case_inactive, case_fade_out))."""
    p = tab.p
    H = p.num_mem_blocks * p.nf

    p_int, p_fr = _filter_params(p, pitch_index)
    p_int = torch.where(active, p_int, 0).to(torch.int32)
    p_fr = torch.where(active, p_fr, 0).to(torch.int32)

    act = active[:, None]
    c_num_new = torch.where(act, tab.ltpf_num[None, :], 0.0)
    c_den_new = torch.where(act, tab.ltpf_den_tab[p_fr.long()], 0.0)

    case_inactive = ~active & ~st.active
    case_fade_out = ~active & st.active
    same_pitch = (p_int == st.p_int) & (p_fr == st.p_fr)
    case_steady = active & st.active & same_pitch
    case_pitch_change = active & st.active & ~same_pitch

    xcat = torch.cat([st.hist_x, x], dim=1)  # [S, H + nf]
    # case-5 fade-in samples read base and numerator from the pass-A
    # scratch; the selection is per output position
    use_scratch = case_pitch_change[:, None] & tab.in_fade[None, :]  # [S, nf]
    fadeB = torch.where(case_steady[:, None], 1.0, tab.fade_up[None, :])
    args = (p, xcat, st.hist_y, st.c_num, st.c_den, st.p_int,
            c_num_new, c_den_new, p_int, tab.fade_down, fadeB, use_scratch,
            H, _reach_back(p))
    return args, (p_int, p_fr, c_num_new, c_den_new), (case_inactive, case_fade_out)


def _fir(c, src, start: int, n: int):
    """out[s, i] = left fold over k = 0..l of c[s, k] * src[s, start + i - k],
    for i in [0, n), with l = c.shape[1] - 1. Products are rounded once
    each, then summed in order k = 0, 1, ..., l."""
    l = c.shape[1] - 1
    win = src[:, start - l : start + n].unfold(1, l + 1, 1)  # [S, n, l+1]; j = l - k
    prod = win * c.flip(1)[:, None, :]
    acc = prod[..., l]
    for j in range(l - 1, -1, -1):
        acc = acc + prod[..., j]
    return acc


def _blocked_filter_pass(p, ycat, num, base, fade, c_den, off, H, rb):
    """The IIR in blocks of B samples, in place on ycat [S, H + nf + l_den]:
    y[n] = base[n] - fade[n] * (num[n] - den[n]), where den[n] folds
    c_den over ycat[H + n - rb + off + l_den - k]. A block reads ycat as it
    stood before the block (positions at or past the write cursor are
    reached only through zero coefficients for a real pitch lag).

    Where every stream with a nonzero denominator reaches back at least L
    >= B samples, blocks of L samples read exactly the values blocks of B
    read, so the loop takes the longer blocks (about 5 instead of 30 per
    pass at 48 kHz)."""
    nf, l_den = p.nf, p.l_den
    B = 16 if nf % 16 == 0 else 15
    S = ycat.shape[0]
    dev = ycat.device
    reach = rb - off.long() - l_den  # nearest tap's distance behind the sample
    live = (c_den != 0).any(dim=1)
    L = int(torch.where(live, reach, nf).min()) if S else nf
    step = min(L, nf) if L >= B else B
    # gather offsets of tap j = l_den - k for each sample b of a block
    rel = (off.long()[:, None, None] - rb
           + torch.arange(step, device=dev)[None, :, None]
           + torch.arange(l_den + 1, device=dev)[None, None, :])  # [S, step, l_den+1]
    cflip = c_den.flip(1)[:, None, :]
    fade = fade.expand(S, nf)
    for n0 in range(0, nf, step):
        w = min(step, nf - n0)
        q = H + n0
        idx = (rel[:, :w] + q).reshape(S, -1)
        win = torch.gather(ycat, 1, idx).view(S, w, l_den + 1)
        prod = win * cflip
        den = prod[..., l_den]
        for j in range(l_den - 1, -1, -1):
            den = den + prod[..., j]
        sl = slice(n0, n0 + w)
        ycat[:, q : q + w] = base[:, sl] - fade[:, sl] * (num[:, sl] - den)
    return ycat[:, H : H + nf]
