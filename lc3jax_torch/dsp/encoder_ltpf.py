"""Batched LTPF pitch analysis of the encoder (port of
lc3jax/dsp/encoder_ltpf.py; reference encoder/long_term_post_filter.rs).

The 12.8 kHz polyphase resampler, the 50 Hz biquad, the 6.4 kHz downsample,
the weighted lag search over 17..114, the 12.8 kHz refinement with its
fractional interpolation, and the normalized-correlation activation with
its hysteresis state, vectorised over streams. Every sum is the oracle's
left-to-right f32 fold (lc3jax/ref/ltpf_enc.py), so the pitch decisions
match it on the same knife edges; the per-stream windows the TPU version
extracted with gather-free funnels are plain indexing here.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import fp
from .. import tables as T
from ..config import FrameDuration, Lc3Config

F32 = np.float32
NMEM = 232
K_MIN, K_MAX = 17, 114
NLAGS = K_MAX + 1 - K_MIN


@dataclass(frozen=True)
class LtpfEncConsts:
    len12: int
    len64: int
    delay: int
    up: int
    ext_len: int
    scale: float  # f32 up * resampling factor
    resamp_idx: torch.Tensor  # int64 [len12, ntaps] x_ext index of each tap, in fold order
    resamp_tap: torch.Tensor  # f32 [len12, ntaps], 0 past a row's taps
    lag_idx: torch.Tensor  # int64 [NLAGS, len64] x64 window of each lag
    lag_weight: torch.Tensor  # f32 [NLAGS]
    interp_r: torch.Tensor  # f32 [31]
    h_taps: torch.Tensor  # f32 [4, 5] activation taps h[4k - d + 7] by (d, k), 0 if unused


def _consts_np(cfg: Lc3Config):
    if cfg.n_ms == FrameDuration.MS10:
        len12, len64, delay = 128, 64, 24
    else:
        len12, len64, delay = 96, 48, 44
    up = {8000: 24, 16000: 12, 24000: 8, 32000: 6, 44100: 4, 48000: 4}[cfg.fs]
    resamp = F32(0.5) if cfg.fs == 8000 else F32(1.0)
    rows = []
    for n in range(len12):  # the oracle's resampler plan (ref/ltpf_enc.py:57-69)
        idxs, taps = [], []
        for k in range(-120 // up, 120 // up + 1):
            index_x_s = (15 * n) // up + k - 120 // up
            index_h = up * k - ((15 * n) % up)
            if -120 < index_h < 120:
                idxs.append(240 // up + index_x_s)
                taps.append(T.TAB_RESAMP_FILTER[119 + index_h])
        rows.append((idxs, taps))
    ntaps = max(len(i) for i, _ in rows)
    ridx = np.zeros((len12, ntaps), np.int64)
    rtap = np.zeros((len12, ntaps), F32)
    for n, (idxs, taps) in enumerate(rows):
        ridx[n, : len(idxs)] = idxs
        rtap[n, : len(taps)] = taps
    lag_idx = (K_MAX - K_MIN - np.arange(NLAGS))[:, None] + np.arange(len64)[None, :]
    weight = np.array([F32(1.0) - F32(0.5) * F32(k) / F32(K_MAX - K_MIN) for k in range(NLAGS)],
                      F32)
    h = np.asarray(T.TAB_LTPF_INTERP_X12K8, F32)
    h_taps = np.zeros((4, 5), F32)
    for d in range(4):
        for j, k in enumerate(range(-2, 3)):
            hi = 4 * k - d
            if -8 < hi < 8:
                h_taps[d, j] = h[hi + 7]
    return dict(len12=len12, len64=len64, delay=delay, up=up, ext_len=240 // up + cfg.nf,
                scale=float(F32(up) * resamp), ridx=ridx, rtap=rtap, lag_idx=lag_idx,
                weight=weight, h_taps=h_taps)


@lru_cache(maxsize=None)
def ltpf_enc_consts(cfg: Lc3Config, device: torch.device) -> LtpfEncConsts:
    c = _consts_np(cfg)
    t = lambda a: torch.as_tensor(a, device=device)
    return LtpfEncConsts(
        len12=c["len12"], len64=c["len64"], delay=c["delay"], up=c["up"],
        ext_len=c["ext_len"], scale=c["scale"], resamp_idx=t(c["ridx"]),
        resamp_tap=t(c["rtap"]), lag_idx=t(c["lag_idx"]), lag_weight=t(c["weight"]),
        interp_r=t(np.asarray(T.TAB_LTPF_INTERP_R, F32)), h_taps=t(c["h_taps"]),
    )


@dataclass
class LtpfEncState:
    x_ext: torch.Tensor  # f32 [S, ext_len] input history at fs
    x12: torch.Tensor  # f32 [S, len12 + delay + NMEM]
    x64: torch.Tensor  # f32 [S, 64 + K_MAX]
    h50_m1: torch.Tensor  # f32 [S]
    h50_m2: torch.Tensor  # f32 [S]
    t_prev: torch.Tensor  # int32 [S]
    mem_pitch: torch.Tensor  # f32 [S]
    mem_active: torch.Tensor  # bool [S]
    mem_nc: torch.Tensor  # f32 [S]
    mem_mem_nc: torch.Tensor  # f32 [S]


def ltpf_enc_init(cfg: Lc3Config, n_streams: int, device="cpu") -> LtpfEncState:
    c = _consts_np(cfg)
    f = lambda *shape: torch.zeros(n_streams, *shape, dtype=torch.float32, device=device)
    return LtpfEncState(
        x_ext=f(c["ext_len"]), x12=f(c["len12"] + c["delay"] + NMEM), x64=f(64 + K_MAX),
        h50_m1=f(), h50_m2=f(),
        t_prev=torch.full((n_streams,), K_MIN, dtype=torch.int32, device=device),
        mem_pitch=f(), mem_active=torch.zeros(n_streams, dtype=torch.bool, device=device),
        mem_nc=f(), mem_mem_nc=f(),
    )


def _row_gather(a, idx):
    """a [S, L], idx [S, ...] int64 -> a[s, idx[s, ...]]."""
    S = a.shape[0]
    return a.gather(1, idx.reshape(S, -1)).reshape(idx.shape)


def ltpf_analysis(cfg: Lc3Config, tab, st: LtpfEncState, x_s, near_nyquist, nbits: int):
    """Returns (fields dict, new state). x_s int16 [S, nf]."""
    c = tab.ltpf
    len12, len64 = c.len12, c.len64
    S = x_s.shape[0]
    dev = x_s.device
    if cfg.n_ms == FrameDuration.MS7P5:
        t_nbits = int(np.floor(nbits * 10.0 / 7.5 + 0.5))
    else:
        t_nbits = nbits
    gain_ltpf_on = t_nbits < 560 + cfg.fs_ind * 80

    # shift histories
    num = 240 // c.up
    x_ext = torch.cat([st.x_ext[:, st.x_ext.shape[1] - num :], x_s.to(torch.float32)], dim=1)

    # polyphase resampling to 12.8 kHz: each output a fold over its taps
    xe = x_ext[:, c.resamp_idx]  # [S, len12, ntaps]
    x12_new = fp.seq_fold(xe * c.resamp_tap, 2) * c.scale

    # 50 Hz biquad high-pass, sample by sample
    b0, b1, b2 = float(F32(0.9827947082978771)), float(F32(-1.965589416595754)), \
        float(F32(0.9827947082978771))
    a1, a2 = float(F32(-1.9652933726226904)), float(F32(0.9658854605688177))
    m1, m2 = st.h50_m1, st.h50_m2
    ys = []
    for n in range(len12):
        h = (x12_new[:, n] - a1 * m1) - a2 * m2
        ys.append((b0 * h + b1 * m1) + b2 * m2)
        m1, m2 = h, m1
    x12 = torch.cat([st.x12[:, len12:], torch.stack(ys, 1)], dim=1)

    # 6.4 kHz downsample (5-tap window, stride 2), left-associated
    c5 = [float(F32(v)) for v in (0.1236796411180537, 0.2353512128364889, 0.2819382920909148,
                                  0.2353512128364889, 0.1236796411180537)]
    base = NMEM - 3
    x64_new = c5[0] * x12[:, base : base + 2 * len64 : 2]
    for j in range(1, 5):
        x64_new = x64_new + c5[j] * x12[:, base + j : base + j + 2 * len64 : 2]
    # the oracle's shift + write: the new frame lands at [K_MAX, K_MAX + len64)
    x64 = torch.cat([st.x64[:, len64 : len64 + K_MAX], x64_new, st.x64[:, K_MAX + len64 :]],
                    dim=1)

    # weighted autocorrelation over lags 17..114
    cur = x64[:, K_MAX : K_MAX + len64]
    r = fp.seq_fold(x64[:, c.lag_idx] * cur[:, None, :], 2)  # [S, NLAGS]
    rw = c.lag_weight * r
    lag_t1 = rw.argmax(1) + K_MIN  # the first maximum, as the oracle's scan
    t_prev = st.t_prev.long()
    k_from = torch.clamp_min(t_prev - 4, K_MIN) - K_MIN
    k_to = torch.clamp_max(t_prev + 4, K_MAX) - K_MIN + 1
    lanes = torch.arange(NLAGS, device=dev)[None, :]
    in_win = (lanes >= k_from[:, None]) & (lanes < k_to[:, None])
    lag_t2 = torch.where(in_win, r, -torch.inf).argmax(1) + K_MIN

    # normalisation energies of the windows at lags 0, t1, t2
    lags = torch.stack([torch.zeros_like(lag_t1), lag_t1, lag_t2], 1)  # [S, 3]
    seg = _row_gather(x64, (K_MAX - lags)[:, :, None] + torch.arange(len64, device=dev))
    nv = fp.seq_fold(seg * seg, 2)  # [S, 3]
    r_at = lambda lag: r.gather(1, (lag - K_MIN)[:, None])[:, 0]
    clip0 = lambda v: torch.where(v > 0.0, v, 0.0)  # max(0, v): NaN -> 0
    nc1 = clip0(r_at(lag_t1) / torch.sqrt(nv[:, 0] * nv[:, 1]))
    nc2 = torch.where(lag_t1 == lag_t2, nc1, clip0(r_at(lag_t2) / torch.sqrt(nv[:, 0] * nv[:, 2])))
    take2 = nc2 > 0.85 * nc1
    t_current = torch.where(take2, lag_t2, lag_t1)
    pitch_present = torch.where(take2, nc2 > 0.6, nc1 > 0.6)

    # pitch refinement at 12.8 kHz over lags k_min - 4 .. k_min + 12
    k_min2 = torch.clamp_min(2 * t_current - 4, 32)
    k_max2 = torch.clamp_max(2 * t_current + 4, 228)
    kvals = (k_min2 - 4)[:, None] + torch.arange(17, device=dev)  # [S, 17]
    cur12 = x12[:, NMEM : NMEM + len12]
    widx = (NMEM - kvals)[:, :, None] + torch.arange(len12, device=dev)
    wins12 = _row_gather(x12, widx.clamp(min=0))  # lags past k_max2 + 4 are never read
    r12 = fp.seq_fold(cur12[:, None, :] * wins12, 2)  # [S, 17]
    valid = (kvals >= k_min2[:, None]) & (kvals <= k_max2[:, None])
    masked = torch.where(valid, r12, -torch.inf)
    best_rel = masked.argmax(1)
    found = masked.gather(1, best_rel[:, None])[:, 0] > 0.0  # the oracle starts at 0
    best_rel = torch.where(found, best_rel, 4)
    pitch_int = (k_min2 - 4) + best_rel

    # fractional refinement: d scanned in ascending order, strict >, from 0
    r12_at = {m: r12.gather(1, (best_rel + m).clamp(0, 16)[:, None])[:, 0] for m in range(-4, 5)}

    def interp_at(d):
        total = None
        for m in range(-4, 5):
            nidx = 4 * m - d
            if -16 < nidx < 16:
                term = r12_at[m] * c.interp_r[nidx + 15]
                total = term if total is None else total + term
        return total

    case_32 = pitch_int == 32
    case_mid = (pitch_int > 32) & (pitch_int < 127)
    case_hi = (pitch_int >= 127) & (pitch_int < 157)
    best_val = torch.zeros(S, dtype=torch.float32, device=dev)
    pitch_fr = torch.zeros(S, dtype=torch.int64, device=dev)
    for d in range(-3, 4):
        allow = case_mid | (case_32 & (d >= 0)) | (case_hi & (d % 2 == 0))
        v = interp_at(d)
        better = allow & (v > best_val)
        best_val = torch.where(better, v, best_val)
        pitch_fr = torch.where(better, d, pitch_fr)
    neg = pitch_fr < 0
    pitch_int = torch.where(neg, pitch_int - 1, pitch_int)
    pitch_fr = torch.where(neg, pitch_fr + 4, pitch_fr)
    pitch_index = torch.where(
        pitch_int < 127, 4 * pitch_int + pitch_fr - 128,
        torch.where(pitch_int < 157, 2 * pitch_int + pitch_fr // 2 - 126, pitch_int + 283))

    # activation: x(n, d) = sum_k x12[NMEM + off + n - k] * h[4k - d + 7],
    # k = -2..2 in order; unused taps are exact zeros
    h0 = c.h_taps[0]
    hp = c.h_taps[pitch_fr]  # [S, 5]
    n12 = torch.arange(len12, device=dev)
    no_delay = None
    shifted = None
    sh_base = (NMEM - pitch_int)[:, None] + n12[None, :]  # [S, len12]
    for j, k in enumerate(range(-2, 3)):
        nd = x12[:, NMEM - k : NMEM - k + len12] * h0[j]
        sh = _row_gather(x12, sh_base - k) * hp[:, j : j + 1]
        no_delay = nd if no_delay is None else no_delay + nd
        shifted = sh if shifted is None else shifted + sh
    sums = fp.seq_fold(torch.stack([no_delay * shifted, no_delay * no_delay, shifted * shifted],
                                   1), 2)  # [S, 3]
    denom = torch.sqrt(sums[:, 1] * sums[:, 2])
    nc = torch.where(denom > 0.0, sums[:, 0] / denom, 0.0)
    pitch = pitch_int.to(torch.float32) + pitch_fr.to(torch.float32) / 4.0

    cond_start = (~st.mem_active
                  & ((cfg.n_ms == FrameDuration.MS10) | (st.mem_mem_nc > 0.94))
                  & (st.mem_nc > 0.94) & (nc > 0.94))
    cond_hold = st.mem_active & (nc > 0.9)
    cond_near = (st.mem_active & ((pitch - st.mem_pitch).abs() < 2.0)
                 & ((nc - st.mem_nc) > -0.1) & (nc > 0.84))
    ltpf_active = (cond_start | cond_hold | cond_near) & gain_ltpf_on & ~near_nyquist

    new_state = LtpfEncState(
        x_ext=x_ext,
        x12=x12[:, x12.shape[1] - (len12 + c.delay + NMEM) :],
        x64=x64,
        h50_m1=m1,
        h50_m2=m2,
        t_prev=t_current.to(torch.int32),
        mem_pitch=torch.where(pitch_present, pitch, 0.0),
        mem_active=pitch_present & ltpf_active,
        mem_nc=torch.where(pitch_present, nc, 0.0),
        mem_mem_nc=st.mem_nc,
    )
    fields = dict(
        pitch_index=torch.where(pitch_present, pitch_index, 0).to(torch.int32),
        pitch_present=pitch_present,
        ltpf_active=ltpf_active & pitch_present,
        nbits_ltpf=torch.where(pitch_present, 11, 1).to(torch.int32),
    )
    return fields, new_state
