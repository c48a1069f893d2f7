"""Batched LC3 encoder analysis: PCM [S, nf] -> bitstream fields (port of
lc3jax/dsp/encoder.py).

One call of `encode_step` encodes one frame of S streams. The stages follow
the reference encoder's order (encoder/lc3_encoder.rs:63-112): forward
MDCT, bandwidth and attack detectors, SNS analysis with its two-stage VQ,
TNS, LTPF pitch analysis (encoder_ltpf.py), the spectral quantizer with its
bit model, the residual bits and the noise level. The output is the JAX
step's dict of integer fields, which coding/host_pack.py packs into bytes
on the host, or, with emit_pack, coding/pack_kernel.py on the device.

Four stages launch hand-written CUDA kernels on the card, each with a plain
PyTorch version that a CPU tensor takes: the SNS PVQ search
(sns_kernel.py), the TNS autocorrelation and analysis lattice
(tns_enc_kernel.py), and the bit model's table lookups, twice a step
(bitmodel_kernel.py; the second pass also emits the range coder's operands
when emit_pack is on).

Exactness. The encoder must give the oracle's bytes (lc3jax/ref), which
sits on f32 knife edges (quantizer rounding, PVQ and codebook argmins). So:

- every sum the oracle folds left to right is folded left to right here
  (`fp.seq_fold`, or a loop of adds over a padded axis: adding 0.0 is
  exact), never `torch.sum`/`cumsum`, whose order differs between the CPU
  and CUDA; integer sums use torch freely;
- products and sums keep the oracle's association, one eager op each
  (PyTorch never contracts them into fma);
- exp2f is glibc's algorithm (libmexact.py), powf tables are made once in
  float64 (equal to glibc for every argument used), log10f, log2f and asinf
  are float64 rounded once to f32;
- TF32 stays off and nothing here is compiled.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import numpy as np
import torch

from .. import fp
from .. import tables as T
from ..compiled import CompiledStep
from ..config import FrameDuration, Lc3Config
from ..devices import resolve_device
from . import bitmodel_kernel, libmexact, sns_kernel, tns_enc_kernel
from .encoder_ltpf import LtpfEncState, ltpf_analysis, ltpf_enc_init
from .fftexact import batched_dct_iv

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = np.float32
I32 = torch.int32
EPS = float(np.finfo(np.float32).eps)
NBITS_SNS = 38
SZ_A = 2390004  # MPVQ index range of shape A (spectral_noise_shaping.rs)
# the global gain adjustment's bit thresholds by fs_ind (ref/quant.py:238-267)
GAIN_ADJUST_T1 = (80, 230, 380, 530, 680)
GAIN_ADJUST_T2 = (500, 1025, 1550, 2075, 2600)
GAIN_ADJUST_T3 = (850, 1700, 2550, 3400, 4250)


# ------------------------------------------------------------------ params


@dataclass(frozen=True)
class EncoderParams:
    """Static per-config encoder constants (numpy)."""

    cfg: Lc3Config
    window: np.ndarray  # [2nf]
    mdct_gain: np.float32
    band_idx: np.ndarray  # [nb + 1] band edges
    nn_split: int  # near-Nyquist band split
    preemph: np.ndarray  # [64]
    group_idx: np.ndarray  # [16, 6] sm index of each grouping term, in fold order
    group_w: np.ndarray  # [16, 6] its weight
    band_of_line: np.ndarray  # [ne]
    bw_start: np.ndarray  # [4]
    bw_stop: np.ndarray
    bw_l: np.ndarray
    tns_bounds: np.ndarray  # [5, 2, 2]
    tns_sub: np.ndarray  # [5, 2, 3, 2] sub-block (start, stop)
    nf_bw_stop: np.ndarray  # [5] noise-level stop
    nf_start: int
    nf_width: int
    attack_blocks: int
    attack_pos_limit: int
    num_downsampled: int


@lru_cache(maxsize=None)
def encoder_params(cfg: Lc3Config) -> EncoderParams:
    idx = T.band_indices(cfg)
    bol = np.zeros(cfg.ne, dtype=np.int64)
    for b in range(cfg.nb):
        bol[idx[b] : idx[b + 1]] = b

    g_tilt = [14, 18, 22, 26, 30][cfg.fs_ind]
    expo = F32(g_tilt) / F32(630.0)
    preemph = np.array([fp.powf(F32(10.0), F32(b) * expo) for b in range(64)], dtype=F32)

    # 64 -> 16 grouping in the oracle's term order (ref/sns_enc.py:90-104)
    w6 = np.array([1.0 / 12.0, 2.0 / 12.0, 3.0 / 12.0, 3.0 / 12.0, 2.0 / 12.0, 1.0 / 12.0],
                  dtype=F32)
    gidx = np.zeros((16, 6), dtype=np.int64)
    gw = np.zeros((16, 6), dtype=F32)
    gidx[0], gw[0] = [0, 0, 1, 2, 3, 4], w6
    for b2 in range(1, 15):
        gidx[b2], gw[b2] = 4 * b2 - 1 + np.arange(6), w6
    gidx[15], gw[15] = [63, 59, 60, 61, 62, 63], w6[[5, 0, 1, 2, 3, 4]]

    if cfg.n_ms == FrameDuration.MS10:
        bw_start = np.array([[53, 0, 0, 0], [47, 59, 0, 0], [44, 54, 60, 0], [41, 51, 57, 61]])
        bw_stop = np.array([[63, 0, 0, 0], [56, 63, 0, 0], [52, 59, 63, 0], [49, 55, 60, 63]])
        bw_l = np.array([4, 4, 3, 1])
        nn_split = cfg.nb - 2
        tns_bounds = np.array([[[12, 80], [80, 80]], [[12, 160], [160, 160]],
                               [[12, 240], [240, 240]], [[12, 160], [160, 320]],
                               [[12, 200], [200, 400]]])
        tns_sub = np.array([
            [[[12, 34], [34, 57], [57, 80]], [[0, 0], [0, 0], [0, 0]]],
            [[[12, 61], [61, 110], [110, 160]], [[0, 0], [0, 0], [0, 0]]],
            [[[12, 88], [88, 164], [164, 240]], [[0, 0], [0, 0], [0, 0]]],
            [[[12, 61], [61, 110], [110, 160]], [[160, 213], [213, 266], [266, 320]]],
            [[[12, 74], [74, 137], [137, 200]], [[200, 266], [266, 333], [333, 400]]],
        ])
        nf_bw_stop = np.array([80, 160, 240, 320, 400])
        nf_start, nf_width = 24, 3
        attack_blocks, attack_lim, num_ds = 4, 2, 160
    else:
        bw_start = np.array([[51, 0, 0, 0], [45, 58, 0, 0], [42, 53, 60, 0], [40, 51, 57, 61]])
        bw_stop = np.array([[63, 0, 0, 0], [55, 63, 0, 0], [51, 58, 63, 0], [48, 55, 60, 63]])
        bw_l = np.array([4, 4, 3, 2])
        nn_split = cfg.nb - 4
        tns_bounds = np.array([[[9, 60], [60, 60]], [[9, 120], [120, 120]],
                               [[9, 180], [180, 180]], [[9, 120], [120, 240]],
                               [[9, 150], [150, 300]]])
        tns_sub = np.array([
            [[[9, 26], [26, 43], [43, 60]], [[0, 0], [0, 0], [0, 0]]],
            [[[9, 46], [46, 83], [83, 120]], [[0, 0], [0, 0], [0, 0]]],
            [[[9, 66], [66, 123], [123, 180]], [[0, 0], [0, 0], [0, 0]]],
            [[[9, 46], [46, 82], [82, 120]], [[120, 159], [159, 200], [200, 240]]],
            [[[9, 56], [56, 103], [103, 150]], [[150, 200], [200, 250], [250, 300]]],
        ])
        nf_bw_stop = np.array([60, 120, 180, 240, 300])
        nf_start, nf_width = 18, 2
        attack_blocks, attack_lim, num_ds = 3, 1, 120

    return EncoderParams(
        cfg=cfg,
        window=T.mdct_window(cfg).copy(),
        mdct_gain=F32(1.0) / np.sqrt(F32(2.0) * F32(cfg.nf)),
        band_idx=np.asarray(idx, np.int64),
        nn_split=nn_split,
        preemph=preemph,
        group_idx=gidx,
        group_w=gw,
        band_of_line=bol,
        bw_start=bw_start[cfg.fs_ind - 1] if cfg.fs_ind > 0 else np.zeros(4, int),
        bw_stop=bw_stop[cfg.fs_ind - 1] if cfg.fs_ind > 0 else np.zeros(4, int),
        bw_l=bw_l,
        tns_bounds=tns_bounds,
        tns_sub=tns_sub,
        nf_bw_stop=nf_bw_stop,
        nf_start=nf_start,
        nf_width=nf_width,
        attack_blocks=attack_blocks,
        attack_pos_limit=attack_lim,
        num_downsampled=num_ds,
    )


def gain_table(nbits: int, fs_ind: int) -> tuple[np.ndarray, int]:
    """The quantizer's 256 global gains 10^((i + gg_off)/28) (glibc powf)."""
    fs = fs_ind + 1
    gg_off = -min(115, nbits // (10 * fs)) - 105 - 5 * fs
    table = np.array(
        [fp.powf(F32(10.0), F32(F32(i) + F32(gg_off)) / F32(28.0)) for i in range(256)],
        dtype=F32,
    )
    return table, gg_off


# ------------------------------------------------------------------- state


@dataclass
class EncoderState:
    time_buf: torch.Tensor  # f32 [S, 2nf] MDCT history
    att_energy_last: torch.Tensor  # f32 [S]
    att_max_energy_last: torch.Tensor  # f32 [S]
    att_pos_last: torch.Tensor  # int32 [S]
    att_tm1: torch.Tensor  # f32 [S]
    att_tm2: torch.Tensor  # f32 [S]
    quant_reset_offset: torch.Tensor  # bool [S]
    quant_nbits_offset: torch.Tensor  # f32 [S]
    quant_nbits_spec: torch.Tensor  # int32 [S]
    quant_nbits_est: torch.Tensor  # int32 [S]
    ltpf: LtpfEncState


def encoder_init(cfg: Lc3Config, n_streams: int, device="cuda") -> EncoderState:
    device = resolve_device(device)
    z = lambda dt=torch.float32: torch.zeros(n_streams, dtype=dt, device=device)
    return EncoderState(
        time_buf=torch.zeros(n_streams, 2 * cfg.nf, dtype=torch.float32, device=device),
        att_energy_last=z(),
        att_max_energy_last=z(),
        att_pos_last=torch.full((n_streams,), -1, dtype=I32, device=device),
        att_tm1=z(),
        att_tm2=z(),
        quant_reset_offset=z(torch.bool),
        quant_nbits_offset=z(),
        quant_nbits_spec=z(I32),
        quant_nbits_est=z(I32),
        ltpf=ltpf_enc_init(cfg, n_streams, device),
    )


def _tables(cfg, nbits, device):
    from ..convert import encoder_tables

    return encoder_tables(cfg, nbits, device)


# ------------------------------------------------------------------ stages


def forward_mdct(tab, time_buf, x_s):
    """Window fold + bit-exact DCT-IV + band energies + near-Nyquist flag,
    f32 op for f32 op as the oracle (ref/mdct_enc.py)."""
    p = tab.p
    nf, z = p.cfg.nf, p.cfg.z
    half = nf // 2
    mid = 3 * half
    new_buf = torch.cat([time_buf[:, nf : 2 * nf - z], x_s.to(torch.float32),
                         torch.zeros_like(time_buf[:, :z])], dim=1)
    w = tab.window
    t1 = new_buf[:, mid - half : mid].flip(1)
    w1 = w[mid - half : mid].flip(0)
    t2 = new_buf[:, mid : mid + half]
    w2 = w[mid : mid + half]
    first = (-(t1 * w1)) - (t2 * w2)
    t1 = new_buf[:, :half]
    w1 = w[:half]
    t2 = new_buf[:, half:nf].flip(1)
    w2 = w[half:nf].flip(0)
    second = (t1 * w1) - (t2 * w2)
    spec = batched_dct_iv(nf)(torch.cat([first, second], dim=1)) * float(p.mdct_gain)

    x = spec[:, : p.cfg.ne]
    # E_B[b] = sum over the band of x^2 / width, folded in line order; lines
    # past a band's width add an exact 0
    xb = x[:, tab.band_lines]  # [S, nb, maxw]
    terms = torch.where(tab.band_valid, (xb * xb) / tab.band_width[:, None], 0.0)
    energy = fp.seq_fold(terms, 2)
    if p.cfg.fs <= 32000:
        lower = fp.seq_fold(energy[:, : p.nn_split], 1)
        upper = fp.seq_fold(energy[:, p.nn_split :], 1)
        nn = upper > 30.0 * lower
    else:
        nn = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    return new_buf, x, energy, nn


def bandwidth_detect(tab, e_b):
    """Two-stage band-limit detector (ref/encoder_stages.py:39-69)."""
    p = tab.p
    fs_ind = p.cfg.fs_ind
    nbits = [0, 1, 2, 2, 3][fs_ind]
    S = e_b.shape[0]
    dev = e_b.device
    if fs_ind == 0:
        return torch.zeros(S, dtype=I32, device=dev), nbits

    # stage 1: the highest candidate that is not quiet (the mean divides by
    # the band's width as a device tensor: tab.divisors)
    bw_ind = torch.zeros(S, dtype=I32, device=dev)
    found = torch.zeros(S, dtype=torch.bool, device=dev)
    thresh = [20.0, 10.0, 10.0, 10.0]
    for k in range(fs_ind - 1, -1, -1):
        start, stop = int(p.bw_start[k]), int(p.bw_stop[k])
        quiet = fp.seq_fold(e_b[:, start : stop + 1] / tab.divisors[f"bandwidth_width_{k}"], 1)
        hit = (quiet >= thresh[k]) & ~found
        bw_ind = torch.where(hit, k + 1, bw_ind)
        found = found | hit

    # stage 2: the cutoff check of the chosen candidate; the running max
    # keeps Python's max(cutoff, cutoff_max) semantics, NaN included
    cut_thresh = [15.0, 23.0, 20.0, 20.0]
    final = torch.full((S,), fs_ind, dtype=I32, device=dev)
    for cand in range(fs_ind):
        l_bw = int(p.bw_l[cand])
        frm = int(p.bw_start[cand]) + 1 - l_bw
        to = int(p.bw_start[cand])
        cmax = torch.zeros(S, dtype=torch.float32, device=dev)
        for n in range(frm, to):
            c = e_b[:, n - l_bw] / e_b[:, n]
            cmax = torch.where(cmax > c, cmax, c)
        keep = cmax > cut_thresh[cand]
        final = torch.where((bw_ind == cand) & keep, cand, final)
    final = torch.where(bw_ind == fs_ind, fs_ind, final)
    return final.to(I32), nbits


def attack_active(cfg: Lc3Config, nbytes: int) -> bool:
    fs = cfg.fs
    if cfg.n_ms == FrameDuration.MS7P5:
        return (fs == 32000 and 61 <= nbytes < 150) or (fs >= 44100 and 75 <= nbytes < 150)
    return (fs == 32000 and nbytes > 80) or (fs >= 41000 and nbytes >= 100)


def attack_detect(p: EncoderParams, state: EncoderState, x_s, nbytes: int):
    """Attack detector (ref/encoder_stages.py:72-128); is_active is static."""
    cfg = p.cfg
    S = x_s.shape[0]
    dev = x_s.device
    if not attack_active(cfg, nbytes):
        zeros = torch.zeros(S, dtype=torch.float32, device=dev)
        return torch.zeros(S, dtype=torch.bool, device=dev), dict(
            att_energy_last=zeros, att_max_energy_last=zeros.clone(),
            att_pos_last=torch.full((S,), -1, dtype=I32, device=dev),
            att_tm1=state.att_tm1, att_tm2=state.att_tm2,
        )

    nds = p.num_downsampled
    block = cfg.nf // nds
    ds = x_s.to(torch.int64).reshape(S, nds, block).sum(2).to(torch.float32)  # exact
    prev = torch.cat([state.att_tm1[:, None], ds[:, :-1]], dim=1)
    prev2 = torch.cat([state.att_tm2[:, None], state.att_tm1[:, None], ds[:, :-2]], dim=1)
    hp = (0.375 * ds - 0.5 * prev) + 0.125 * prev2
    hb = hp.reshape(S, p.attack_blocks, 40)
    blocks = fp.seq_fold(hb * hb, 2)  # [S, nblocks]

    energy_last = state.att_energy_last
    max_energy_last = state.att_max_energy_last
    attack_pos = torch.full((S,), -1, dtype=I32, device=dev)
    for n in range(p.attack_blocks):
        energy = blocks[:, n]
        max_energy = torch.maximum(0.25 * max_energy_last, energy_last)
        attack_pos = torch.where(energy > 8.5 * max_energy, n, attack_pos)
        energy_last = energy
        max_energy_last = max_energy
    detected = (attack_pos >= 0) | (state.att_pos_last >= p.attack_pos_limit)
    return detected, dict(
        att_energy_last=energy_last, att_max_energy_last=max_energy_last,
        att_pos_last=attack_pos.to(I32), att_tm1=ds[:, -1], att_tm2=ds[:, -2],
    )


# ------------------------------------------------------------- SNS encoder


def sns_analysis(tab, x, e_b, attack):
    """SNS analysis and two-stage VQ (ref/sns_enc.py); returns the shaped
    spectrum and the bitstream fields. Stage 2's PVQ search is the kernel."""
    p = tab.p
    nb = p.cfg.nb
    diff = 64 - nb
    if diff > 0:
        padded = torch.cat([e_b[:, :diff].repeat_interleave(2, dim=1), e_b[:, diff:]], dim=1)
    else:
        padded = e_b
    sm = torch.cat([
        0.75 * padded[:, :1] + 0.25 * padded[:, 1:2],
        (0.25 * padded[:, :-2] + 0.5 * padded[:, 1:-1]) + 0.25 * padded[:, 2:],
        0.25 * padded[:, -2:-1] + 0.75 * padded[:, -1:],
    ], dim=1)
    sm = sm * tab.preemph
    total = fp.seq_fold(sm, 1)
    noise_floor = torch.clamp_min((total / 64.0) * 1e-4, 2.0**-32)
    sm = torch.maximum(sm, noise_floor[:, None])
    sm = fp.log2f(EPS + sm) / 2.0

    ds = fp.seq_fold(sm[:, tab.group_idx] * tab.group_w, 2)  # [S, 16]
    mean = fp.seq_fold(ds, 1)[:, None] / 16.0
    ds = 0.85 * (ds - mean)

    # attack smoothing: windowed means in the oracle's fold order (divided
    # by device tensors: tab.divisors)
    d5, d3 = tab.divisors["sns_attack_5"], tab.divisors["sns_attack_3"]
    pad = torch.cat([ds[:, :1], ds[:, :1], ds, ds[:, -1:], ds[:, -1:]], dim=1)
    att = (((pad[:, 0:16] + pad[:, 1:17]) + pad[:, 2:18]) + pad[:, 3:19] + pad[:, 4:20]) / d5
    att = torch.cat([
        ((ds[:, 0:1] + ds[:, 1:2]) + ds[:, 2:3]) / d3,
        (((ds[:, 0:1] + ds[:, 1:2]) + ds[:, 2:3]) + ds[:, 3:4]) / 4.0,
        att[:, 2:14],
        (((ds[:, 12:13] + ds[:, 13:14]) + ds[:, 14:15]) + ds[:, 15:16]) / 4.0,
        ((ds[:, 13:14] + ds[:, 14:15]) + ds[:, 15:16]) / d3,
    ], dim=1)
    atten = 0.5 if p.cfg.n_ms == FrameDuration.MS10 else 0.3
    att = atten * (att - fp.seq_fold(att, 1)[:, None] / 16.0)
    scf = torch.where(attack[:, None], att, ds)

    # stage 1: codebook MSE search, the oracle's per-row fold (first min wins)
    e_lf = scf[:, None, :8] - tab.lfcb[None]
    e_hf = scf[:, None, 8:] - tab.hfcb[None]
    ind_lf = fp.seq_fold(e_lf * e_lf, 2).argmin(1)
    ind_hf = fp.seq_fold(e_hf * e_hf, 2).argmin(1)
    st1 = torch.cat([tab.lfcb[ind_lf], tab.hfcb[ind_hf]], dim=1)
    r1 = scf - st1

    # stage 2: rotation (row-major fold), then the PVQ kernel
    t2rot = fp.seq_fold(r1[:, :, None] * tab.dct16[None], 1)
    y_sel, y0s, xq_sel, shape_j, gind, g_sel = sns_kernel.sns_pvq(t2rot)
    return _sns_finish(tab, x, st1, ind_lf, ind_hf, y_sel, y0s, xq_sel, shape_j, gind, g_sel)


def _sns_finish(tab, x, st1, ind_lf, ind_hf, y_sel, y0s, xq_sel, shape_j, gind, g_sel):
    """MPVQ enumeration, joint index, scale-factor synthesis, interpolation
    and spectral shaping (ref/sns_enc.py:129-155, 354-377)."""
    p = tab.p
    S = x.shape[0]
    nb = p.cfg.nb
    lanes = torch.arange(16, device=x.device)
    sj = shape_j.long()

    long_a = sj[:, None] >= 2
    idxa, ls_inda = _mpvq_enum_batch(tab, torch.where(long_a | (lanes < 10), y_sel, 0),
                                     torch.where(sj >= 2, 16, 10))
    idxb, ls_indb = _mpvq_enum_batch(
        tab, torch.cat([y0s[:, 10:], torch.zeros_like(y0s[:, :10])], dim=1),
        torch.full_like(sj, 6))
    lsb_gain = gind.long() & 1
    joint = torch.stack([(2 * idxb + ls_indb + 2) * SZ_A + idxa, lsb_gain * SZ_A + idxa,
                         idxa, 15158272 + lsb_gain + 2 * idxa], dim=1)
    index_joint = joint.gather(1, sj[:, None])[:, 0]
    ls_indb = torch.where(sj == 0, ls_indb, 0)

    # synthesis: factor[n] = sum over col of xq_sel[col] * D[n, col], folded
    factor = fp.seq_fold(xq_sel[:, None, :] * tab.dct16[None], 2)
    scfq = st1 + g_sel[:, None] * factor
    n0 = scfq[:, :-1]
    dd = scfq[:, 1:] - n0
    mids = n0[:, :, None] + tab.interp_w * dd[:, :, None]
    last_d = scfq[:, 15] - scfq[:, 14]
    interp = torch.cat([scfq[:, :1], scfq[:, :1], mids.reshape(S, 60),
                        (scfq[:, 15] + 0.125 * last_d)[:, None],
                        (scfq[:, 15] + 0.375 * last_d)[:, None]], dim=1)
    if nb < 64:
        # the reference encoder's narrow-band quirk (spectral_noise_shaping.rs
        # :185-201): bands diff..nb-1 all take the original interp[diff + 1]
        n2 = 64 - nb
        head = (interp[:, 0 : 2 * n2 : 2] + interp[:, 1 : 2 * n2 : 2]) / 2.0
        tail = interp[:, n2 + 1 : n2 + 2].expand(S, nb - n2)
        interp = torch.cat([head, tail], dim=1)
    else:
        interp = interp[:, :nb]
    g_sns = libmexact.exp2f(-interp)
    x_shaped = x * g_sns[:, tab.band_of_line]

    fields = dict(
        ind_lf=ind_lf.to(I32), ind_hf=ind_hf.to(I32), shape_j=shape_j.to(I32),
        gind=gind.to(I32), ls_inda=ls_inda.to(I32), ls_indb=ls_indb.to(I32),
        index_joint_j=index_joint.to(I32),
    )
    return x_shaped, fields


def _mpvq_enum_batch(tab, y, dims):
    """Batched MPVQ enumeration (ref/sns_enc.py:232-255): y [S, 16] signed
    pulses, dims [S] in {6, 10, 16}; positions dims-1..0 per stream."""
    S = y.shape[0]
    dev = y.device
    y = y.long()
    index = torch.zeros(S, dtype=torch.int64, device=dev)
    next_sign = torch.full((S,), -1, dtype=torch.int64, device=dev)  # -1: unset
    k_acc = torch.zeros(S, dtype=torch.int64, device=dev)
    tmp_h = torch.zeros(S, dtype=torch.int64, device=dev)  # MPVQ_OFFSETS[0][0] == 0
    for pos in range(15, -1, -1):
        in_range = pos < dims
        val = y[:, pos]
        index = torch.where(in_range & (next_sign >= 0) & (val != 0), 2 * index + next_sign,
                            index)
        next_sign = torch.where(in_range & (val < 0), 1,
                                torch.where(in_range & (val > 0), 0, next_sign))
        index = torch.where(in_range, index + tmp_h, index)
        k_acc = torch.where(in_range, k_acc + val.abs(), k_acc)
        nrow = (dims - 1) if pos == 0 else (dims - pos)  # the oracle's row counter
        new_h = tab.mpvq_offsets[nrow.clamp(0, 15), k_acc.clamp(max=10)]
        tmp_h = torch.where(in_range, new_h, tmp_h)
    return index, next_sign.clamp(min=0)


# --------------------------------------------------------------- TNS encode


def tns_analysis_batch(tab, x, bw_ind, nbits: int, near_nyquist):
    """TNS (ref/tns_enc.py): the coefficient kernel (autocorrelation,
    Levinson-Durbin, LPC weighting, reflection coefficients and their
    quantisation, the bit budget), then the analysis lattice (kernel)."""
    cfg = tab.p.cfg
    if cfg.n_ms == FrameDuration.MS10:
        lpc_weighting = 1 if nbits < 480 else 0
    else:
        lpc_weighting = 1 if nbits < 360 else 0
    bw = bw_ind.long()
    bounds = tab.tns_bounds[bw]  # [S, 2, 2]
    num_filters = torch.where(bw >= 3, 2, 1).to(I32)
    _, rc_i, rc_q, rc_order, nbits_tns = tns_enc_kernel.tns_coefficients(
        tab, x, bw_ind, near_nyquist, lpc_weighting)
    x_f = tns_enc_kernel.tns_analysis(x, bounds, rc_order, num_filters, rc_q)
    return x_f, dict(
        nbits_tns=nbits_tns, lpc_weighting=lpc_weighting,
        num_tns_filters=num_filters, rc_order=rc_order, rc_i=rc_i,
    )


# ------------------------------------------------------- spectral quantizer


def spectral_quantize(tab, state: EncoderState, x_f, nbits: int, nbits_bw: int,
                      nbits_tns, nbits_ltpf, emit_pack: bool = False):
    """Gain search, quantization and bit model (ref/quant.py). emit_pack adds
    fields["pack_tables"], the range coder's operands for the final
    quantization, from the second bit-model pass (the pack kernel's input)."""
    p = tab.p
    cfg = p.cfg
    S, ne = x_f.shape
    dev = x_f.device
    fs_ind = cfg.fs_ind

    nbits_ari = int(np.ceil(np.log2(ne / 2.0))) + (3 if nbits <= 1280 else 4 if nbits <= 2560 else 5)
    nbits_spec = (nbits - nbits_bw - NBITS_SNS - 8 - 3 - nbits_ari
                  - nbits_tns.long() - nbits_ltpf.long())  # [S]

    prev = (state.quant_nbits_offset + state.quant_nbits_spec.float()) - state.quant_nbits_est.float()
    nbits_offset = torch.where(
        state.quant_reset_offset, 0.0,
        0.8 * state.quant_nbits_offset + 0.2 * prev.clamp(-40.0, 40.0))
    nbits_spec_adj = ((nbits_spec.float() + nbits_offset) + 0.5).to(torch.int64)

    gg_off = tab.gg_off
    # 4-line energies in dB, left-associated adds (ref/quant.py:102-110)
    sq = x_f.reshape(S, ne // 4, 4)
    sq = sq * sq
    total4 = ((sq[:, :, 0] + sq[:, :, 1]) + sq[:, :, 2]) + sq[:, :, 3]
    e = 10.0 * fp.log10f(EPS + total4)  # [S, ne/4]

    # gain bisection (ref/quant.py:112-143). Its 8 steps test 8 of the 256
    # gain indices; the oracle's f32 fold over the reversed energies is run
    # once for all 256 thresholds ([S, 256] wide) and the bisection reads it
    k28, k20 = 28.0, tab.divisors["gain_estimate"]
    c27 = float(F32(2.7) * F32(28.0) / F32(20.0))
    c43 = float(F32(43.0) * F32(28.0) / F32(20.0))
    c36 = float(F32(36.0) * F32(28.0) / F32(20.0))
    c7 = float(F32(7.0) * F32(28.0) / F32(20.0))
    thr = (torch.arange(256, device=dev) + gg_off).to(torch.float32)[None, :]  # exact
    scaled = e * k28 / k20
    sc2 = ((2.0 * e) * k28) / k20
    tmp = torch.zeros(S, 256, dtype=torch.float32, device=dev)
    seen = torch.zeros(S, 256, dtype=torch.bool, device=dev)
    for i in range(ne // 4 - 1, -1, -1):
        sc = scaled[:, i : i + 1]
        above = sc >= thr
        far = thr < (sc - c43)
        a_term = torch.where(far, (sc2[:, i : i + 1] - 2.0 * thr) - c36, (sc - thr) + c7)
        term = torch.where(above, a_term, torch.where(seen, c27, 0.0))
        tmp = tmp + term
        seen = seen | above
    limit = ((nbits_spec_adj.float() * 1.4) * k28) / k20
    over = (tmp > limit[:, None]) & seen  # seen at the end: some energy above
    fac = 256
    gg_ind = torch.full((S,), 255, dtype=torch.int64, device=dev)
    for _ in range(8):
        fac >>= 1
        gg_ind = gg_ind - fac
        gg_ind = torch.where(over.gather(1, gg_ind[:, None])[:, 0], gg_ind + fac, gg_ind)

    # gain limitation
    x_max = x_f.abs().amax(1)
    gg_min = torch.where(
        x_max > 0.0,
        torch.ceil(28.0 * fp.log10f(x_max / tab.divisors["gain_limit"])).to(torch.int64) - gg_off, 0)
    reset_offset = (gg_ind < gg_min) | (x_max == 0.0)
    gg_ind = torch.where(reset_offset, gg_min, gg_ind)

    def quant_only(gi):
        gg = tab.gg_table[gi.clamp(0, 255)]
        scaled_x = x_f / gg[:, None]
        offs = torch.where(x_f >= 0.0, scaled_x + 0.375, scaled_x - 0.375)
        return torch.trunc(offs).clamp(-32768.0, 32767.0).to(I32), gg

    # pass 1: its bit model feeds the adaptation state and the adjustment
    x_q1, gg1 = quant_only(gg_ind)
    bc = bit_consumption(tab, x_q1, nbits, nbits_spec)
    new_quant_state = dict(
        quant_nbits_offset=nbits_offset, quant_nbits_est=bc["nbits_est"].to(I32),
        quant_reset_offset=reset_offset, quant_nbits_spec=nbits_spec.to(I32),
    )

    # global gain adjustment (ref/quant.py:238-267), in the oracle's f32 ops
    t1, t2, t3 = GAIN_ADJUST_T1[fs_ind], GAIN_ADJUST_T2[fs_ind], GAIN_ADJUST_T3[fs_ind]
    tmp1 = F32(t1) / F32(16.0) + F32(3.0)
    tmp2 = F32(t2) / F32(48.0)
    est = bc["nbits_est"]
    nbe = est.float()
    delta = torch.where(
        est < t1, (nbe + 48.0) / 16.0,
        torch.where(est < t2,
                    ((nbe - float(t1)) * float(tmp2 - tmp1)) / tab.divisors["gain_adjust"]
                    + float(tmp1),
                    torch.where(est < t3, nbe / tab.divisors["gain_adjust_48"],
                                torch.full_like(nbe, float(F32(t3) / F32(48.0))))))
    delta = torch.floor(delta + 0.5)
    delta2 = delta + 2.0
    nspec_f = nbits_spec.float()
    down = nbe < nspec_f - delta2
    cond = ((gg_ind < 255) & (est > nbits_spec)) | ((gg_ind > 0) & down)
    adj = torch.where(down, -1, torch.where((gg_ind == 254) | (nbe < nspec_f + delta), 1, 2))
    new_gg_ind = torch.where(cond, torch.maximum(gg_ind + adj, gg_min), gg_ind)
    adjusted = new_gg_ind != gg_ind

    # pass 2 on the merged quantization: lanes that did not adjust repeat
    # pass 1's bit model exactly, so one final pass gives every field
    x_q2, gg2 = quant_only(new_gg_ind)
    x_qf = torch.where(adjusted[:, None], x_q2, x_q1)
    gg = torch.where(adjusted, gg2, gg1)
    bcf = bit_consumption(tab, x_qf, nbits, nbits_spec, emit_pack=emit_pack)
    x_q = torch.where(torch.arange(ne, device=dev)[None, :] < bcf["lastnz_trunc"][:, None],
                      x_qf, 0)
    lsb_mode = bcf["mode_flag"] & (bcf["nbits_est"] > nbits_spec)

    fields = dict(
        gg_ind=new_gg_ind.to(I32), nbits_spec=nbits_spec.to(I32),
        nbits_lsb=bcf["nbits_lsb"].to(I32), nbits_trunc=bcf["nbits_trunc"].to(I32),
        lsb_mode=lsb_mode, rate_flag=bcf["rate_flag"],
        lastnz_trunc=bcf["lastnz_trunc"].to(I32), gg=gg,
    )
    if emit_pack:
        fields["pack_tables"] = bcf["pack_tables"]
    return x_q, fields, new_quant_state


def bit_consumption(tab, x_q, nbits: int, nbits_spec, emit_pack: bool = False):
    """Arithmetic-coder bit model, parallel over tuples (ref/quant.py:173-236;
    the JAX derivation at lc3jax/dsp/encoder.py:1121-1136). The context of
    tuple n depends only on the two tuples before it, so every tuple is
    independent; the table lookups are the kernel, the rest is integers.
    emit_pack adds "pack_tables" (bitmodel_kernel.bitmodel_table_part)."""
    fs_ind = tab.p.cfg.fs_ind
    ne = x_q.shape[1]
    rate_flag = 512 if nbits > (160 + fs_ind * 160) else 0
    mode_flag = nbits >= (480 + fs_ind * 160)
    t = tuple_symbols(x_q)
    est_c = bitmodel_kernel.bitmodel_table_part(t["c"], t["g"], t["sym"], rate_flag, ne,
                                                t["lastnz"], emit_pack=emit_pack)
    if emit_pack:
        est_c, pk = est_c
    out = _bit_consumption_tail(est_c.long(), t["a0"], t["b0"], t["g"], t["go0"], t["lastnz"],
                                nbits_spec, mode_flag, rate_flag, ne // 2)
    if emit_pack:
        out["pack_tables"] = pk
    return out


def tuple_symbols(x_q) -> dict:
    """Per tuple of x_q [S, ne]: magnitudes a0, b0, escape-ladder depth g
    (and whether it is > 0, go0), final symbol sym, context c; and lastnz.
    All int32, the widths the bit-model kernel reads."""
    S, ne = x_q.shape
    dev = x_q.device
    NT = ne // 2
    pairs = x_q.reshape(S, NT, 2).to(I32)
    pair_nz = (pairs != 0).any(2)
    last_idx = torch.where(pair_nz, torch.arange(NT, dtype=I32, device=dev), -1).amax(1)
    lastnz = torch.clamp_min(2 * (last_idx + 1), 2)

    a0 = pairs[:, :, 0].abs()
    b0 = pairs[:, :, 1].abs()
    m = torch.maximum(a0, b0)
    go = m[:, :, None] >= (4 << torch.arange(14, dtype=I32, device=dev))  # [S, NT, 14]
    g = go.sum(2, dtype=I32)  # ladder depth
    lev_fin = g.clamp(max=3)
    a_f = a0 >> g
    b_f = b0 >> g
    sym = (a_f + 4 * b_f).clamp(0, 16)
    t_pos = torch.where(lev_fin <= 1, 1 + (a_f + b_f) * (lev_fin + 1), 12 + lev_fin)
    t1 = torch.nn.functional.pad(t_pos[:, :-1], (1, 0))
    t2 = torch.nn.functional.pad(t_pos[:, :-2], (2, 0))
    c = (t2 & 15) * 16 + t1  # [S, NT] in [0, 256)
    return dict(a0=a0, b0=b0, g=g, go0=go[:, :, 0], sym=sym, c=c, lastnz=lastnz)


def _bit_consumption_tail(est_c, a0, b0, g, go0, lastnz, nbits_spec, mode_flag,
                          rate_flag, NT):
    """After the table lookups: sign and payload bits, the running total and
    the truncation point (ref/quant.py:188-236), in exact integers."""
    dev = est_c.device
    go0 = go0.long()
    if mode_flag:
        est_c = est_c + 4096 * (g - go0)
        lev_pos = g > 0
        nlsb_c = (2 * go0 + (lev_pos & ((a0 >> 1) == 0) & (a0 != 0)).long()
                  + (lev_pos & ((b0 >> 1) == 0) & (b0 != 0)).long())
    else:
        est_c = est_c + 4096 * g
        nlsb_c = torch.zeros_like(g)
    est_c = est_c + 2048 * ((a0 > 0).long() + (b0 > 0).long())

    ns_arr = 2 * torch.arange(NT, device=dev)
    in_range = ns_arr[None, :] < lastnz[:, None]
    est_cum = torch.where(in_range, est_c, 0).cumsum(1)  # integers: any order is exact
    est = est_cum[:, -1]
    nlsb = torch.where(in_range, nlsb_c, 0).sum(1)
    ceil2048 = lambda v: (v + 2047) // 2048
    fits = ((a0 != 0) | (b0 != 0)) & (ceil2048(est_cum) <= nbits_spec[:, None]) & in_range
    lastnz_tr = torch.clamp_min(torch.where(fits, ns_arr[None, :] + 2, 0).amax(1), 2)
    trunc = torch.where(fits, est_cum, 0).amax(1)
    return dict(
        lastnz=lastnz, lastnz_trunc=lastnz_tr, nbits_est=ceil2048(est) + nlsb,
        nbits_trunc=ceil2048(trunc), nbits_lsb=nlsb, mode_flag=mode_flag, rate_flag=rate_flag,
    )


def residual_bits_batch(nbits_spec, nbits_trunc, gg, x_f, x_q):
    """Residual refinement bits (ref/encoder_stages.py:158-169), spectrally
    aligned: the bit of line k sits at index k; the packer walks the nonzero
    lines of x_q."""
    max_bits = torch.clamp_min(nbits_spec.long() - nbits_trunc.long() + 4, 0)
    nz = x_q != 0
    pos = nz.long().cumsum(1) - 1  # integers
    emit = nz & (pos < max_bits[:, None])
    bit = x_f >= x_q.to(torch.float32) * gg[:, None]
    return bit & emit, emit.sum(1).to(I32)


def noise_level_batch(tab, x_f, x_q, bw_ind, gg):
    """Noise factor 0..7 (ref/encoder_stages.py:131-155); the level's sum is
    the oracle's fold in line order."""
    p = tab.p
    S, ne = x_f.shape
    dev = x_f.device
    k = torch.arange(ne, device=dev)
    bw_stop = tab.nf_bw_stop[bw_ind.long()][:, None]  # [S, 1]
    zero = (x_q == 0) | (k[None, :] >= bw_stop)
    w = p.nf_width
    zpad = torch.nn.functional.pad(zero, (w, w), value=True)
    kpad = torch.arange(-w, ne + w, device=dev)[None, :]
    ok = zpad | (kpad >= bw_stop)  # window positions at or past bw_stop are not read
    window_zero = ok[:, 0:ne]
    for d in range(1, 2 * w + 1):
        window_zero = window_zero & ok[:, d : d + ne]
    relevant = window_zero & (k[None, :] >= p.nf_start) & (k[None, :] < torch.clamp_max(bw_stop, ne))
    contrib = torch.where(relevant, x_f.abs() / gg[:, None], 0.0)
    total = fp.seq_fold(contrib[:, p.nf_start :], 1)
    count = relevant.sum(1)
    level = torch.where(count > 0, total / count.clamp(min=1).to(torch.float32), 0.0)
    diff = 8.0 - 16.0 * level
    return torch.where(diff >= 0.0, torch.clamp_max((diff + 0.5).to(I32), 7), 0).to(I32)


# ------------------------------------------------------------- fused step


def encode_step(cfg: Lc3Config, nbytes: int, state: EncoderState, x_s,
                emit_pack: bool = False):
    """One batched frame: PCM [S, nf] int16 -> (state, bitstream fields), on
    the device of the state. The fields carry the JAX step's names.

    emit_pack adds fields["quant_pack_tables"], the range coder's operands
    for the pack kernel (coding/pack_kernel.py); leave it off for the host
    packer. Only the second bit-model pass emits them."""
    nbits = nbytes * 8
    tab = _tables(cfg, nbits, state.time_buf.device)
    p = tab.p

    time_buf, x, e_b, near_nyquist = forward_mdct(tab, state.time_buf, x_s)
    bw_ind, nbits_bw = bandwidth_detect(tab, e_b)
    attack, att_state = attack_detect(p, state, x_s, nbytes)
    x, sns_fields = sns_analysis(tab, x, e_b, attack)
    x, tns_fields = tns_analysis_batch(tab, x, bw_ind, nbits, near_nyquist)
    ltpf_fields, ltpf_state = ltpf_analysis(cfg, tab, state.ltpf, x_s, near_nyquist, nbits)
    x_q, quant_fields, quant_state = spectral_quantize(
        tab, state, x, nbits, nbits_bw, tns_fields["nbits_tns"], ltpf_fields["nbits_ltpf"],
        emit_pack=emit_pack)
    res_bits, n_res = residual_bits_batch(
        quant_fields["nbits_spec"], quant_fields["nbits_trunc"], quant_fields["gg"], x, x_q)
    noise_factor = noise_level_batch(tab, x, x_q, bw_ind, quant_fields["gg"])

    new_state = EncoderState(time_buf=time_buf, ltpf=ltpf_state, **att_state, **quant_state)
    fields = dict(
        bandwidth=bw_ind, nbits_bw=nbits_bw, x_q=x_q, residual_bits=res_bits,
        n_residual=n_res, noise_factor=noise_factor,
        **{f"sns_{k}": v for k, v in sns_fields.items()},
        **{f"tns_{k}": v for k, v in tns_fields.items()},
        **{f"ltpf_{k}": v for k, v in ltpf_fields.items()},
        **{f"quant_{k}": v for k, v in quant_fields.items()},
    )
    return new_state, fields


def make_encode_step(cfg: Lc3Config, nbytes: int, device="cuda") -> CompiledStep:
    """encode_step compiled for (cfg, nbytes): `step(state, pcm) ->
    (state, fields)`, one CUDA graph per stream count S on `device` (the
    counterpart of lc3jax's `jax.jit(partial(encode_step, cfg, nbytes),
    donate_argnums=(0,))`). The state is donated as in
    `dsp.decoder.make_decode_step`; the fields are fresh tensors each call."""
    return CompiledStep(partial(encode_step, cfg, nbytes), ("encode_step", cfg, nbytes), device)
