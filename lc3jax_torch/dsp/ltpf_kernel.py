"""Both LTPF synthesis passes: the CUDA kernel (csrc/ltpf.cu) and its
plain PyTorch version.

Replaces lc3jax/dsp/pallas_ltpf.py:ltpf_both_passes_pallas, with its
signature. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from .ltpf import _blocked_filter_pass, _fir

launches = 0  # kernel launches since the last reset


def ltpf_both_passes_plain(p, xcat, hist_y, c_num_a, c_den_a, p_int_a,
                           c_num_b, c_den_b, p_int_b, fade_down, fadeB,
                           use_scratch, H: int, rb: int):
    """Plain PyTorch version of both LTPF passes -> (yA, yB) [S, nf].

    Translates _blocked_filter_pass (pass A) and
    _blocked_filter_pass_perstream (pass B) of lc3jax/dsp/ltpf.py, with
    per-stream gathers in place of the funnel shifter."""
    nf, l_num, l_den = p.nf, p.l_num, p.l_den
    S = xcat.shape[0]
    ceil_half = l_den - l_den // 2
    off_a = torch.clamp(rb - p_int_a - ceil_half, 0, rb)
    off_b = torch.clamp(rb - p_int_b - ceil_half, 0, rb)
    pad = torch.zeros(S, nf + l_den, dtype=xcat.dtype, device=xcat.device)

    # pass A: fade-out with the previous coefficients
    num_a = _fir(c_num_a, xcat, H, nf)
    yA = _blocked_filter_pass(p, torch.cat([hist_y, pad], 1), num_a, xcat[:, H:],
                              fade_down[None, :], c_den_a, off_a, H, rb)

    # pass B: the case-5 numerator source is the last l_num history samples
    # followed by pass A's output; selected per output sample
    scratch = torch.cat([hist_y[:, H - l_num :], yA], 1)  # [S, l_num + nf]
    num_x = _fir(c_num_b, xcat, H, nf)
    num_s = _fir(c_num_b, scratch, l_num, nf)
    num_b = torch.where(use_scratch, num_s, num_x)
    base_b = torch.where(use_scratch, scratch[:, l_num:], xcat[:, H:])
    yB = _blocked_filter_pass(p, torch.cat([hist_y, pad], 1), num_b, base_b,
                              fadeB, c_den_b, off_b, H, rb)
    return yA, yB


def ltpf_both_passes(p, xcat, hist_y, c_num_a, c_den_a, p_int_a, c_num_b, c_den_b,
                     p_int_b, fade_down, fadeB, use_scratch, H: int, rb: int):
    """Returns (yA [S, nf], yB [S, nf]) f32 for any S >= 1."""
    if H < rb:
        raise ValueError(f"ltpf_both_passes: history {H} shorter than reach-back {rb}")
    if xcat.device.type == "cpu":
        return ltpf_both_passes_plain(p, xcat, hist_y, c_num_a, c_den_a, p_int_a,
                                      c_num_b, c_den_b, p_int_b, fade_down, fadeB,
                                      use_scratch, H, rb)
    if xcat.device.type != "cuda":
        raise ValueError(f"ltpf_both_passes: unsupported device {xcat.device}")
    global launches
    nf, l_num, l_den = p.nf, p.l_num, p.l_den
    S = xcat.shape[0]
    B = 16 if nf % 16 == 0 else 15
    dev = xcat.device
    f32_shapes = {
        "xcat": (xcat, (S, H + nf)), "hist_y": (hist_y, (S, H)),
        "c_num_a": (c_num_a, (S, l_num + 1)), "c_den_a": (c_den_a, (S, l_den + 1)),
        "c_num_b": (c_num_b, (S, l_num + 1)), "c_den_b": (c_den_b, (S, l_den + 1)),
        "fade_down": (fade_down, (nf,)), "fadeB": (fadeB, (S, nf)),
    }
    for name, (t, shape) in f32_shapes.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"ltpf_both_passes: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("p_int_a", p_int_a), ("p_int_b", p_int_b), ("use_scratch", use_scratch)):
        if t.device != dev or t.shape[0] != S:
            raise ValueError(f"ltpf_both_passes: {name} must have {S} rows on {dev}")

    ceil_half = l_den - l_den // 2
    off_a = torch.clamp(rb - p_int_a - ceil_half, 0, rb).to(torch.int32).contiguous()
    off_b = torch.clamp(rb - p_int_b - ceil_half, 0, rb).to(torch.int32).contiguous()
    # streams on the fast axis: a warp's loads of one sample are coalesced
    xcat_t = xcat.t().contiguous()
    hist_t = hist_y.t().contiguous()
    fadeB_t = fadeB.t().contiguous()
    sel_t = use_scratch.t().to(torch.int32).contiguous()
    cna, cda = c_num_a.contiguous(), c_den_a.contiguous()
    cnb, cdb = c_num_b.contiguous(), c_den_b.contiguous()
    fd = fade_down.contiguous()
    ycat_t = torch.empty((H + nf + l_den, S), dtype=torch.float32, device=dev)
    sbuf_t = torch.empty((l_num + nf, S), dtype=torch.float32, device=dev)
    ya_t = torch.empty((nf, S), dtype=torch.float32, device=dev)
    yb_t = torch.empty((nf, S), dtype=torch.float32, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        err = lib.lc3t_ltpf_both_passes(
            xcat_t.data_ptr(), hist_t.data_ptr(), cna.data_ptr(), cda.data_ptr(),
            off_a.data_ptr(), cnb.data_ptr(), cdb.data_ptr(), off_b.data_ptr(),
            fd.data_ptr(), fadeB_t.data_ptr(), sel_t.data_ptr(), ycat_t.data_ptr(),
            sbuf_t.data_ptr(), ya_t.data_ptr(), yb_t.data_ptr(),
            S, H, nf, B, l_num, l_den, rb, _build.stream_ptr(dev),
        )
    _build.check(err, "lc3t_ltpf_both_passes")
    launches += 1
    return ya_t.t(), yb_t.t()
