"""Carries the codec's constants and state between numpy and torch.

The decoder's "weights" are the static per-config tables of
`dsp.params.decoder_params` (numpy): the DCT-IV matrix, the window,
the LCG jump tables, the LTPF taps, the band maps, plus the 256-entry
global-gain table. `decoder_tables` turns them into device tensors once per
(config, frame bits, device); `encoder_tables` does the same for the
encoder's constants (`dsp.encoder.encoder_params`, the quantizer's gain
table, the LTPF resampler).

The state and frame converters take numpy arrays (or anything
`np.asarray` accepts) laid out like the leaves of the JAX pytrees
`DecoderState`, `LtpfState`, `ParsedFrames`, `EncoderState` and
`LtpfEncState`, so the same inputs can be handed to both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import fp
from . import tables as T
from .config import Lc3Config
from .dsp.decoder import BOOL_FRAME_FIELDS, DecoderState, ParsedFrames
from .dsp.encoder import (GAIN_ADJUST_T1, GAIN_ADJUST_T2, EncoderParams, EncoderState, encoder_params,
                          gain_table)
from .dsp.encoder_ltpf import LtpfEncConsts, LtpfEncState, ltpf_enc_consts
from .dsp.ltpf import LtpfState, _gains
from .dsp.params import DecoderParams, decoder_params

F32 = np.float32


@dataclass(frozen=True)
class DecoderTables:
    """Device-resident constants for one (config, frame bits, device)."""

    p: DecoderParams  # the numpy source (static ints and shapes)
    dct: torch.Tensor  # f64 [nf, nf] DCT-IV (the f32 matrix of decoder_params, widened)
    window_rev: torch.Tensor  # f32 [2nf]
    imdct_gain: float
    band_of_line: torch.Tensor  # int64 [ne]
    bw_stop: torch.Tensor  # int64 [5]
    nf_lcg_A: torch.Tensor  # int64 [ne + 2] noise-fill LCG jump tables
    nf_lcg_B: torch.Tensor
    plc_lcg_A: torch.Tensor  # int64 [ne + 2]
    plc_lcg_B: torch.Tensor
    gg_table: torch.Tensor  # f32 [256] 10^((i + gg_off) / 28)
    tns_bounds: torch.Tensor  # int32 [5, 4] (lo0, hi0, lo1, hi1) per bandwidth
    tns_sin: torch.Tensor  # f32 [17] quantised reflection coefficients
    lfcb: torch.Tensor  # f32 [32, 8]
    hfcb: torch.Tensor  # f32 [32, 8]
    sns_gains: torch.Tensor  # f32 [4, 8]
    dct16: torch.Tensor  # f32 [16, 16]
    interp_w: torch.Tensor  # f32 [4]
    ltpf_num: torch.Tensor  # f32 [l_num + 1] the active gain row, scaled
    ltpf_den_tab: torch.Tensor  # f32 [4, l_den + 1] scaled by the gain
    fade_up: torch.Tensor  # f32 [nf]
    fade_down: torch.Tensor  # f32 [nf]
    in_fade: torch.Tensor  # bool [nf]


def global_gain_table(cfg: Lc3Config, nbits: int) -> np.ndarray:
    """Exact 10^((i + gg_off)/28) for the 256 gain indices (glibc powf)."""
    fs = cfg.fs_ind + 1
    gg_off = -min(nbits // (10 * fs), 115) - 105 - 5 * fs
    return np.array(
        [fp.powf(F32(10.0), F32(F32(i) + F32(gg_off)) / F32(28.0)) for i in range(256)],
        dtype=F32,
    )


def tns_sin_table() -> np.ndarray:
    """17-entry sin table; index 0 maps to 0.0 (the rc_i == 0 sentinel)."""
    tab = np.sin(np.pi / 17.0 * (np.arange(17, dtype=np.float64) - 8.0)).astype(F32)
    tab[0] = 0.0
    return tab


@lru_cache(maxsize=None)
def _decoder_tables(cfg: Lc3Config, nbits: int, device: torch.device) -> DecoderTables:
    p = decoder_params(cfg)
    f32 = lambda a: torch.as_tensor(np.asarray(a, F32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    sns_gains = np.zeros((4, 8), F32)
    for j, g in enumerate(T.SNS_GAINS_BY_SHAPE):
        sns_gains[j, : len(g)] = g
    gain_ltpf, gain_ind = _gains(p, nbits)
    n = np.arange(p.nf)
    norm = F32(p.norm)
    in_fade = n < p.sample_2p5ms
    fade_up = np.where(in_fade, n.astype(F32) / norm, F32(1.0)).astype(F32)
    fade_down = np.where(in_fade, F32(1.0) - n.astype(F32) / norm, F32(0.0)).astype(F32)
    return DecoderTables(
        p=p,
        dct=torch.as_tensor(p.dct.astype(np.float64), device=device),
        window_rev=f32(p.window_rev),
        imdct_gain=float(p.imdct_gain),
        band_of_line=i64(p.band_of_line),
        bw_stop=i64(p.bw_stop),
        nf_lcg_A=i64(p.nf_lcg_A),
        nf_lcg_B=i64(p.nf_lcg_B),
        plc_lcg_A=i64(p.plc_lcg_A),
        plc_lcg_B=i64(p.plc_lcg_B),
        gg_table=f32(global_gain_table(cfg, nbits)),
        tns_bounds=torch.as_tensor(
            np.asarray(p.tns_filter_bounds, np.int32).reshape(5, 4), device=device
        ),
        tns_sin=f32(tns_sin_table()),
        lfcb=f32(T.LFCB),
        hfcb=f32(T.HFCB),
        sns_gains=f32(sns_gains),
        dct16=f32(T.DCT16),
        interp_w=f32([0.125, 0.375, 0.625, 0.875]),
        ltpf_num=f32(F32(0.85) * F32(gain_ltpf) * p.ltpf_num_tab[gain_ind]),
        ltpf_den_tab=f32(F32(gain_ltpf) * p.ltpf_den_tab),
        fade_up=f32(fade_up),
        fade_down=f32(fade_down),
        in_fade=torch.as_tensor(in_fade, device=device),
    )


def decoder_tables(cfg: Lc3Config, nbits: int, device="cpu") -> DecoderTables:
    """The decoder's constants on `device`, built once and cached."""
    return _decoder_tables(cfg, int(nbits), torch.device(device))


# ------------------------------------------------------------ frames/state

def parsed_frames_from_numpy(d, device="cpu") -> ParsedFrames:
    """ParsedFrames from a dict of arrays or any object with the 19 fields
    as attributes (a JAX or numpy ParsedFrames)."""
    get = d.__getitem__ if isinstance(d, dict) else lambda k: getattr(d, k)
    out = {}
    for f in dataclasses.fields(ParsedFrames):
        dt = bool if f.name in BOOL_FRAME_FIELDS else np.int32
        out[f.name] = torch.as_tensor(np.asarray(get(f.name)).astype(dt), device=device)
    return ParsedFrames(**out)


_STATE_DTYPES = {
    "plc_seed": np.int32, "plc_lost": np.int32, "p_int": np.int32, "p_fr": np.int32,
    "active": bool,
}


def _tensor(name, a, device):
    return torch.as_tensor(np.asarray(a, _STATE_DTYPES.get(name, F32)), device=device)


def decoder_state_from_numpy(d, device="cpu") -> DecoderState:
    """DecoderState from {field: array, ..., "ltpf": {field: array}} (the
    leaves of the JAX DecoderState / LtpfState)."""
    ltpf = LtpfState(**{
        f.name: _tensor(f.name, d["ltpf"][f.name], device)
        for f in dataclasses.fields(LtpfState)
    })
    return DecoderState(
        ltpf=ltpf,
        **{f.name: _tensor(f.name, d[f.name], device)
           for f in dataclasses.fields(DecoderState) if f.name != "ltpf"},
    )


def decoder_state_to_numpy(st: DecoderState) -> dict:
    """The inverse of decoder_state_from_numpy: nested dict of numpy arrays."""
    out = {f.name: getattr(st, f.name).cpu().numpy()
           for f in dataclasses.fields(DecoderState) if f.name != "ltpf"}
    out["ltpf"] = {f.name: getattr(st.ltpf, f.name).cpu().numpy()
                   for f in dataclasses.fields(LtpfState)}
    return out


# ----------------------------------------------------------------- encoder


@dataclass(frozen=True)
class EncoderTables:
    """Device-resident encoder constants for one (config, frame bits, device)."""

    p: EncoderParams  # the numpy source (static ints and shapes)
    window: torch.Tensor  # f32 [2nf]
    band_lines: torch.Tensor  # int64 [nb, maxw] line index of each band term (0 past the band)
    band_valid: torch.Tensor  # bool [nb, maxw]
    band_width: torch.Tensor  # f32 [nb]
    band_of_line: torch.Tensor  # int64 [ne]
    preemph: torch.Tensor  # f32 [64]
    group_idx: torch.Tensor  # int64 [16, 6]
    group_w: torch.Tensor  # f32 [16, 6]
    lfcb: torch.Tensor  # f32 [32, 8]
    hfcb: torch.Tensor  # f32 [32, 8]
    dct16: torch.Tensor  # f32 [16, 16]
    interp_w: torch.Tensor  # f32 [4]
    mpvq_offsets: torch.Tensor  # int64 [16, 11]
    tns_sub: torch.Tensor  # int32 [5, 2, 3, 2]
    tns_bounds: torch.Tensor  # int32 [5, 2, 2]
    lag_window: torch.Tensor  # f32 [9]
    tns_step: torch.Tensor  # f32 [] pi / 17 (also divisors["tns_step"])
    tns_sin: torch.Tensor  # f32 [17] sinf(step * (i - 8))
    tns_bits: torch.Tensor  # int32 [2 * 8 + 8 * 17]: order bits [2, 8], then coefficient bits [8, 17]
    gg_table: torch.Tensor  # f32 [256]
    gg_off: int
    nf_bw_stop: torch.Tensor  # int64 [5]
    ltpf: LtpfEncConsts
    # {site: f32 [] on the device}, one for each constant, not a power of two,
    # that the encoder divides a tensor by: on a card, `t / c` with c a Python
    # float is t times the reciprocal of c (PyTorch's true division by a CPU
    # scalar), which differs from the oracle's division by one ulp in up to
    # 63% of values (tools/division_check.py); `t / divisors[site]` divides.
    # Sites: sns_attack_5, sns_attack_3, gain_estimate (20), gain_limit
    # (32767.625), gain_adjust (t2 - t1), gain_adjust_48, tns_step, and
    # bandwidth_width_k, the width of bandwidth candidate k < fs_ind
    divisors: dict


LAG_WINDOW = np.array([1.0, 0.9980280260203829, 0.9921354055113971, 0.9823915844707989,
                       0.9689107911912967, 0.9518498073692735, 0.9314049334023056,
                       0.9078082299969592, 0.8813231366694713], dtype=F32)


@lru_cache(maxsize=None)
def _encoder_tables(cfg: Lc3Config, nbits: int, device: torch.device) -> EncoderTables:
    p = encoder_params(cfg)
    f32 = lambda a: torch.as_tensor(np.asarray(a, F32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    widths = np.diff(p.band_idx)
    maxw = int(widths.max())
    lines = p.band_idx[:-1, None] + np.arange(maxw)[None, :]
    valid = np.arange(maxw)[None, :] < widths[:, None]
    step = F32(np.pi / 17.0)
    gg, gg_off = gain_table(nbits, cfg.fs_ind)
    tns_step = f32(step)
    divisors = {
        "sns_attack_5": f32(5.0), "sns_attack_3": f32(3.0), "gain_estimate": f32(20.0),
        "gain_limit": f32(32767.625),
        "gain_adjust": f32(F32(GAIN_ADJUST_T2[cfg.fs_ind]) - F32(GAIN_ADJUST_T1[cfg.fs_ind])),
        "gain_adjust_48": f32(48.0), "tns_step": tns_step,
        **{f"bandwidth_width_{k}": f32(p.bw_stop[k] + 1 - p.bw_start[k]) for k in range(cfg.fs_ind)},
    }
    return EncoderTables(
        p=p,
        window=f32(p.window),
        band_lines=i64(np.where(valid, lines, 0)),
        band_valid=torch.as_tensor(valid, device=device),
        band_width=f32(widths.astype(F32)),
        band_of_line=i64(p.band_of_line),
        preemph=f32(p.preemph),
        group_idx=i64(p.group_idx),
        group_w=f32(p.group_w),
        lfcb=f32(T.LFCB),
        hfcb=f32(T.HFCB),
        dct16=f32(T.DCT16),
        interp_w=f32([0.125, 0.375, 0.625, 0.875]),
        mpvq_offsets=i64(T.MPVQ_OFFSETS),
        tns_sub=torch.as_tensor(np.asarray(p.tns_sub, np.int32), device=device),
        tns_bounds=torch.as_tensor(np.asarray(p.tns_bounds, np.int32), device=device),
        lag_window=f32(LAG_WINDOW),
        tns_step=tns_step,
        tns_sin=f32([np.sin(np.float64(step * (F32(i) - F32(8.0)))) for i in range(17)]),
        tns_bits=torch.as_tensor(np.concatenate([np.ravel(T.AC_TNS_ORDER_BITS),
                                                 np.ravel(T.AC_TNS_COEF_BITS)]).astype(np.int32),
                                 device=device),
        gg_table=f32(gg),
        gg_off=gg_off,
        nf_bw_stop=i64(p.nf_bw_stop),
        ltpf=ltpf_enc_consts(cfg, device),
        divisors=divisors,
    )


def encoder_tables(cfg: Lc3Config, nbits: int, device="cpu") -> EncoderTables:
    """The encoder's constants on `device`, built once and cached."""
    return _encoder_tables(cfg, int(nbits), torch.device(device))


_ENC_STATE_DTYPES = {
    "att_pos_last": np.int32, "quant_reset_offset": bool, "quant_nbits_spec": np.int32,
    "quant_nbits_est": np.int32, "t_prev": np.int32, "mem_active": bool,
}


def _enc_tensor(name, a, device):
    return torch.as_tensor(np.asarray(a, _ENC_STATE_DTYPES.get(name, F32)), device=device)


def encoder_state_from_numpy(d, device="cpu") -> EncoderState:
    """EncoderState from {field: array, ..., "ltpf": {field: array}} (the
    leaves of the JAX EncoderState / LtpfEncState)."""
    ltpf = LtpfEncState(**{
        f.name: _enc_tensor(f.name, d["ltpf"][f.name], device)
        for f in dataclasses.fields(LtpfEncState)
    })
    return EncoderState(
        ltpf=ltpf,
        **{f.name: _enc_tensor(f.name, d[f.name], device)
           for f in dataclasses.fields(EncoderState) if f.name != "ltpf"},
    )


def encoder_state_to_numpy(st: EncoderState) -> dict:
    """The inverse of encoder_state_from_numpy: nested dict of numpy arrays."""
    out = {f.name: getattr(st, f.name).cpu().numpy()
           for f in dataclasses.fields(EncoderState) if f.name != "ltpf"}
    out["ltpf"] = {f.name: getattr(st.ltpf, f.name).cpu().numpy()
                   for f in dataclasses.fields(LtpfEncState)}
    return out


def encoder_fields_to_numpy(fields: dict) -> dict:
    """encode_step's fields as numpy arrays (Python scalars stay scalars),
    the layout the host packer and the JAX step's fields share."""
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in fields.items()}


def pack_tables_from_jax(pk, ne: int) -> np.ndarray:
    """The JAX bit model's emit_pack rows [5 * nt_pad, S] (nt_pad: NT = ne / 2
    rounded up to a multiple of 8, TPU tiling) -> the port's [5 * NT, S]."""
    pk = np.asarray(pk)
    NT = ne // 2
    nt_pad = pk.shape[0] // 5
    if pk.shape[0] != 5 * nt_pad or nt_pad < NT:
        raise ValueError(f"pack tables of {pk.shape[0]} rows do not fit ne = {ne}")
    return pk.reshape(5, nt_pad, -1)[:, :NT].reshape(5 * NT, -1)


def encoder_fields_from_numpy(d: dict, device="cpu") -> dict:
    """The inverse of encoder_fields_to_numpy: encode_step's fields (from
    the port, or the JAX step's as numpy) as tensors on `device`, the
    port's dtypes: bool stays bool, integers become int32, floats float32;
    0-d values become Python ints. quant_pack_tables may come in the JAX
    layout (pack_tables_from_jax)."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = int(a)
            continue
        if k == "quant_pack_tables":
            a = pack_tables_from_jax(a, np.asarray(d["x_q"]).shape[-1])
        dt = bool if a.dtype == bool else F32 if a.dtype.kind == "f" else np.int32
        out[k] = torch.as_tensor(np.ascontiguousarray(a, dt), device=device)
    return out
