"""Both LTPF synthesis passes: the CUDA kernel (csrc/ltpf.cu) and its
plain PyTorch version.

Replaces lc3jax/dsp/pallas_ltpf.py:ltpf_both_passes_pallas, with its
signature. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

On the H100 the filter is a serial chain of nf / B blocks per pass for each
stream, so its time is latency, not bytes. The kernel gives each stream a
half-warp (one lane per sample of a block) and keeps the stream's working
row, input window and scratch in shared memory; it reads the arguments in
their own [S, len] layout and computes the offsets itself, so the wrapper
below checks, allocates the two outputs and makes one launch (no
transposes, casts or offset launches on the card).
"""

from __future__ import annotations

import torch

from .. import _build
from .ltpf import _blocked_filter_pass, _fir


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
    """Returns (yA [S, nf], yB [S, nf]) f32 for any S >= 1.

    On the card every argument is taken as it comes, C-contiguous in its
    own [S, len] layout (p_int_* int32, use_scratch bool); anything else
    raises. The kernel computes the offsets and reads only the window it
    needs, so this wrapper issues one launch and nothing else."""
    if H < rb:
        raise ValueError(f"ltpf_both_passes: history {H} shorter than reach-back {rb}")
    if not xcat.is_cuda:
        if xcat.device.type == "cpu":
            return ltpf_both_passes_plain(p, xcat, hist_y, c_num_a, c_den_a, p_int_a,
                                          c_num_b, c_den_b, p_int_b, fade_down, fadeB,
                                          use_scratch, H, rb)
        raise ValueError(f"ltpf_both_passes: unsupported device {xcat.device}")
    nf, l_num, l_den = p.nf, p.l_num, p.l_den
    S = xcat.shape[0]
    index = xcat.get_device()
    f32, i32 = torch.float32, torch.int32
    args = (("xcat", xcat, f32, (S, H + nf)), ("hist_y", hist_y, f32, (S, H)),
            ("c_num_a", c_num_a, f32, (S, l_num + 1)), ("c_den_a", c_den_a, f32, (S, l_den + 1)),
            ("p_int_a", p_int_a, i32, (S,)),
            ("c_num_b", c_num_b, f32, (S, l_num + 1)), ("c_den_b", c_den_b, f32, (S, l_den + 1)),
            ("p_int_b", p_int_b, i32, (S,)), ("fade_down", fade_down, f32, (nf,)),
            ("fadeB", fadeB, f32, (S, nf)), ("use_scratch", use_scratch, torch.bool, (S, nf)))
    for name, t, dtype, shape in args:
        if t.dtype != dtype or t.shape != shape or t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"ltpf_both_passes: {name} must be a contiguous {dtype} {shape} "
                             f"on {xcat.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    ya = xcat.new_empty((S, nf))  # xcat's type and device, without parsing them again
    yb = xcat.new_empty((S, nf))
    _build.launch("lc3t_ltpf_both_passes", index, *(t.data_ptr() for _, t, _, _ in args),
                  ya.data_ptr(), yb.data_ptr(), S, H, nf, 16 if nf % 16 == 0 else 15,
                  l_num, l_den, rb)
    return ya, yb
