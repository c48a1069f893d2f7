"""Batched decoder: spectral chain + IMDCT + LTPF + output scaling (port of
lc3jax/dsp/decoder.py).

All tensors carry a leading stream axis [S]. Every stage is a plain
function on tensors; the constants come from convert.decoder_tables once
per (config, frame bits, device). The two serial stages run through kernel
wrappers: TNS (dsp/tns_kernel.py) and the LTPF passes (dsp/ltpf_kernel.py).

Numerics: the IMDCT's DCT-IV product runs in float64 and the SNS rotation
in full fp32. TF32 would keep about three decimal digits and break the
1-LSB envelope, so importing this module turns it off for matmuls and cuDNN
alike.

Reference parity: decoder/lc3_decoder.rs:73-154 stage order.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from ..compiled import CompiledStep
from ..config import Lc3Config
from ..devices import resolve_device
from .ltpf import LtpfState, ltpf_init, ltpf_run
from .params import decoder_params
from .tns_kernel import tns_synthesis

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32


@dataclass
class ParsedFrames:
    """Parsed frame fields, batched over streams [S]."""

    x_int: torch.Tensor  # int32 [S, ne] quantized lines (post residual in lsb mode)
    lsb_mode: torch.Tensor  # bool [S]
    gg_ind: torch.Tensor  # int32 [S]
    rc_order: torch.Tensor  # int32 [S, 2]
    rc_i: torch.Tensor  # int32 [S, 16]
    bandwidth: torch.Tensor  # int32 [S]
    noise_factor: torch.Tensor  # int32 [S]
    nf_seed: torch.Tensor  # int32 [S]
    zero_frame: torch.Tensor  # bool [S]
    residual_bits: torch.Tensor  # bool [S, ne], aligned at each nonzero line
    n_residual: torch.Tensor  # int32 [S]
    sns_y: torch.Tensor  # int32 [S, 16] MPVQ de-enumerated pulses
    sns_shape: torch.Tensor  # int32 [S]
    sns_gind: torch.Tensor  # int32 [S]
    sns_ind_lf: torch.Tensor  # int32 [S]
    sns_ind_hf: torch.Tensor  # int32 [S]
    ltpf_active: torch.Tensor  # bool [S]
    pitch_index: torch.Tensor  # int32 [S]
    bad_frame: torch.Tensor  # bool [S]


BOOL_FRAME_FIELDS = frozenset(
    {"lsb_mode", "zero_frame", "residual_bits", "ltpf_active", "bad_frame"})


@dataclass
class DecoderState:
    mem_ola: torch.Tensor  # f32 [S, nf - z]
    plc_spec: torch.Tensor  # f32 [S, ne]
    plc_alpha: torch.Tensor  # f32 [S]
    plc_seed: torch.Tensor  # int32 [S]
    plc_lost: torch.Tensor  # int32 [S]
    ltpf: LtpfState


def decoder_init(cfg: Lc3Config, n_streams: int, device="cuda") -> DecoderState:
    device = resolve_device(device)
    p = decoder_params(cfg)
    return DecoderState(
        mem_ola=torch.zeros(n_streams, cfg.nf - cfg.z, dtype=F32, device=device),
        plc_spec=torch.zeros(n_streams, cfg.ne, dtype=F32, device=device),
        plc_alpha=torch.ones(n_streams, dtype=F32, device=device),
        plc_seed=torch.full((n_streams,), 24607, dtype=torch.int32, device=device),
        plc_lost=torch.zeros(n_streams, dtype=torch.int32, device=device),
        ltpf=ltpf_init(p, n_streams, device),
    )


# --------------------------------------------------------------- stages


def residual_apply(tab, x, x_int, residual_bits, n_residual, lsb_mode):
    """+-0.3125 / -+0.1875 refinement for non-lsb mode (residual_spectrum.rs)."""
    nonzero = x_int != 0
    bit_pos = torch.cumsum(nonzero, dim=1) - 1
    apply = nonzero & (bit_pos < n_residual[:, None]) & ~lsb_mode[:, None]
    pos = x > 0.0
    delta = torch.where(residual_bits, torch.where(pos, 0.3125, 0.1875),
                        torch.where(pos, -0.1875, -0.3125))
    return torch.where(apply, x + delta, x)


def noise_fill(tab, x, x_int, seed, bandwidth, noise_factor, zero_frame):
    """LCG noise fill of all-zero neighbourhoods (noise_filling.rs:18-56)."""
    p = tab.p
    ne, w = p.ne, p.nf_width
    k = torch.arange(ne, device=x.device)[None, :]
    bw_stop = tab.bw_stop[bandwidth.long()][:, None]  # [S, 1]
    # lines in [k - w, k + w] below bw_stop must all be zero: count nonzeros
    # with an exclusive prefix sum over the clamped indicator
    nz = ((x_int != 0) & (k < bw_stop)).to(torch.int32)
    csum = torch.nn.functional.pad(torch.cumsum(nz, dim=1), (1, 0))  # [S, ne + 1]
    hi = torch.clamp(k + w + 1, max=ne).expand_as(nz)
    lo = torch.clamp(k - w, min=0).expand_as(nz)
    window_all_zero = (torch.gather(csum, 1, hi) - torch.gather(csum, 1, lo)) == 0
    in_range = (k >= p.nf_start) & (k < bw_stop)
    fill = window_all_zero & in_range & ~zero_frame[:, None]

    # the m-th filled line takes the m-step LCG jump (u32 math in int64)
    count = torch.cumsum(fill, dim=1)
    seeds = (tab.nf_lcg_A[count] * seed.long()[:, None] + tab.nf_lcg_B[count]) & 0xFFFF
    level = (8.0 - noise_factor.to(F32)) / 16.0
    value = torch.where(seeds < 0x8000, level[:, None], -level[:, None])
    return torch.where(fill, value, x)


def global_gain(tab, x, gg_ind):
    """x * 10^((gg_ind + gg_off)/28), from the table built at init."""
    return x * tab.gg_table[gg_ind.long()][:, None]


def exp2_fast(x):
    """fast-math exp2: 2^floor(x) * quadratic(frac), via the exponent field.

    Matches the reference decoder's fast_math::exp2_raw
    (decoder/spectral_noise_shaping.rs:122)."""
    w = torch.floor(x)
    z = x - w
    approx = 1.0017247 + z * (0.65763628 + z * 0.33718944)
    bits = approx.view(torch.int32) + (w.to(torch.int32) << 23)
    return bits.view(F32)


def sns_synthesis(tab, x, y, shape, gind, ind_lf, ind_hf):
    """SNS decode: stage1 + rotated stage2, interpolate, scale bands."""
    p = tab.p
    S = x.shape[0]
    stage1 = torch.cat([tab.lfcb[ind_lf.long()], tab.hfcb[ind_hf.long()]], dim=1)  # [S, 16]
    yf = y.to(F32)
    y_norm = torch.sqrt(torch.sum(yf * yf, dim=1))
    gain = tab.sns_gains[shape.long(), gind.long()]
    gain = torch.where(y_norm != 0.0, gain / y_norm, gain)
    # the DCT-16 rotation as the oracle's sequential f32 fold over columns
    prod = yf[:, None, :] * tab.dct16[None, :, :]  # [S, n, col]
    factor = prod[..., 0]
    for col in range(1, 16):
        factor = factor + prod[..., col]
    scf = stage1 + gain[:, None] * factor

    # 16 -> 64 interpolation
    n0 = scf[:, :-1]
    dd = scf[:, 1:] - n0
    mids = n0[:, :, None] + tab.interp_w[None, None, :] * dd[:, :, None]  # [S, 15, 4]
    last_d = scf[:, 15] - scf[:, 14]
    interp = torch.cat([
        scf[:, :1], scf[:, :1], mids.reshape(S, 60),
        (scf[:, 15] + 0.125 * last_d)[:, None],
        (scf[:, 15] + 0.375 * last_d)[:, None],
    ], dim=1)  # [S, 64]

    nb = p.cfg.nb
    if nb < 64:  # 8 kHz / 7.5 ms narrow-band reduction
        n2 = 64 - nb
        head = (interp[:, 0 : 2 * n2 : 2] + interp[:, 1 : 2 * n2 : 2]) / 2.0
        interp = torch.cat([head, interp[:, 2 * n2 : n2 + nb]], dim=1)
    else:
        interp = interp[:, :nb]

    g_sns = exp2_fast(interp)  # [S, nb]
    return x * g_sns[:, tab.band_of_line]


def plc_step(tab, x, state: DecoderState, bad_frame):
    """Packet-loss concealment: replay last good spectrum with random signs."""
    ne = tab.p.ne
    alpha_mul = torch.where(state.plc_lost < 8, 0.9, 0.85).to(F32)
    alpha = torch.where(state.plc_lost >= 4, state.plc_alpha * alpha_mul, state.plc_alpha)
    seed0 = state.plc_seed.long()[:, None]
    seeds = (tab.plc_lcg_A[1 : ne + 1] * seed0 + tab.plc_lcg_B[1 : ne + 1]) & 0xFFFF
    concealed = state.plc_spec * torch.where(seeds < 0x8000, alpha[:, None], -alpha[:, None])

    bad = bad_frame[:, None]
    x_out = torch.where(bad, concealed, x)
    next_seed = ((tab.plc_lcg_A[ne] * state.plc_seed.long() + tab.plc_lcg_B[ne]) & 0xFFFF)
    new_state = DecoderState(
        mem_ola=state.mem_ola,
        plc_spec=torch.where(bad, state.plc_spec, x),
        plc_alpha=torch.where(bad_frame, alpha, 1.0),
        plc_seed=torch.where(bad_frame, next_seed.to(torch.int32), state.plc_seed),
        plc_lost=torch.where(bad_frame, state.plc_lost + 1, 0).to(torch.int32),
        ltpf=state.ltpf,
    )
    return x_out, new_state


def imdct_ola(tab, x, mem_ola):
    """Inverse MDCT + overlap-add as a dense matmul (modified_dct.rs).

    The DCT-IV product is taken in float64 and rounded once to float32: an
    fp32 product's summation order (cuBLAS on the card differs from the
    CPU's) flips enough int16 roundings to put quiet content below the 100 dB
    envelope against the oracle's FFT."""
    p = tab.p
    nf, z, ne = p.nf, p.cfg.z, p.ne
    half = nf // 2
    spec = (torch.nn.functional.pad(x, (0, nf - ne)).double() @ tab.dct).float()
    rev = spec.flip(1)
    t_hat = torch.cat([spec[:, half:], -rev[:, :half], -rev[:, half:], -spec[:, :half]], dim=1)
    t_hat = t_hat * tab.imdct_gain
    t_hat = t_hat * tab.window_rev[None, :]
    out = torch.cat([mem_ola + t_hat[:, z:nf], t_hat[:, nf : nf + z]], dim=1)
    return out, t_hat[:, nf + z : 2 * nf]


def output_scale(x):
    """Round half away from zero and saturate to int16."""
    shifted = torch.where(x > 0.0, x + 0.5, x - 0.5)
    return torch.clamp(shifted, -32768.0, 32767.0).to(torch.int32).to(torch.int16)


# --------------------------------------------------------------- fused step


def pre_tns(tab, frames: ParsedFrames):
    """Residual, noise fill and global gain: the lines TNS filters."""
    x = frames.x_int.to(F32)
    x = residual_apply(tab, x, frames.x_int, frames.residual_bits, frames.n_residual,
                       frames.lsb_mode)
    x = noise_fill(tab, x, frames.x_int, frames.nf_seed, frames.bandwidth,
                   frames.noise_factor, frames.zero_frame)
    return global_gain(tab, x, frames.gg_ind)


def decode_spectrum(cfg: Lc3Config, nbits: int, frames: ParsedFrames):
    """The stateless half of decode_step: residual, noise fill, global gain,
    TNS and SNS -> spectral lines x [S, ne]. Streams (or frames of one
    stream) are independent here."""
    from ..convert import decoder_tables

    tab = decoder_tables(cfg, nbits, frames.x_int.device)
    x = pre_tns(tab, frames)
    x = tns_synthesis(tab, x, frames.bandwidth, frames.rc_order, frames.rc_i)
    return sns_synthesis(tab, x, frames.sns_y, frames.sns_shape, frames.sns_gind,
                         frames.sns_ind_lf, frames.sns_ind_hf)


def decode_synthesis(cfg: Lc3Config, nbits: int, state: DecoderState, x,
                     frames: ParsedFrames, debug_taps: bool = False):
    """The stateful half of decode_step: PLC, IMDCT + OLA, LTPF and output
    scaling of spectral lines x [S, ne] -> (state, pcm int16 [S, nf])."""
    from ..convert import decoder_tables

    tab = decoder_tables(cfg, nbits, x.device)
    x, state = plc_step(tab, x, state, frames.bad_frame)
    t, new_mem = imdct_ola(tab, x, state.mem_ola)
    t_pre = t
    ltpf_active = frames.ltpf_active & ~frames.bad_frame
    pitch = torch.where(frames.bad_frame, 0, frames.pitch_index)
    t, new_ltpf = ltpf_run(tab, state.ltpf, t, nbits, ltpf_active, pitch)
    pcm = output_scale(t)
    new_state = DecoderState(
        mem_ola=new_mem,
        plc_spec=state.plc_spec,
        plc_alpha=state.plc_alpha,
        plc_seed=state.plc_seed,
        plc_lost=state.plc_lost,
        ltpf=new_ltpf,
    )
    if debug_taps:
        # stage-attribution taps matching ref.decoder's: spectral lines after
        # SNS/PLC, time signal after IMDCT+OLA but before LTPF
        return new_state, (pcm, {"x_spec": x, "t_pre_ltpf": t_pre})
    return new_state, pcm


def decode_step(cfg: Lc3Config, nbits: int, state: DecoderState, frames: ParsedFrames,
                debug_taps: bool = False):
    """One batched frame: parsed fields [S, ...] -> (state, pcm int16 [S, nf])."""
    x = decode_spectrum(cfg, nbits, frames)
    return decode_synthesis(cfg, nbits, state, x, frames, debug_taps=debug_taps)


def make_decode_step(cfg: Lc3Config, nbits: int, device="cuda") -> CompiledStep:
    """decode_step compiled for (cfg, nbits): `step(state, frames) ->
    (state, pcm)`, one CUDA graph per stream count S on `device` (the
    counterpart of lc3jax's `jax.jit(partial(decode_step, cfg, nbits),
    donate_argnums=(0,))`).

    The state is donated: the state returned is the step's own buffers,
    passing it back costs no copy and updates it in place; a state of your
    own is copied in once, and passing it again raises. Another stream's
    state gets static buffers of its own, so two streams through one step
    stay independent. The PCM is a fresh tensor each call
    (`compiled.CompiledStep`)."""
    return CompiledStep(partial(decode_step, cfg, nbits), ("decode_step", cfg, nbits), device)
