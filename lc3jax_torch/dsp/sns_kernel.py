"""SNS stage 2 (the PVQ pyramid and the shape/gain search): the CUDA kernel
(csrc/sns_pvq.cu) and its plain PyTorch version.

Replaces lc3jax/dsp/pallas_sns.py:sns_pvq_pallas; semantics of the XLA
path of lc3jax/dsp/encoder.py:sns_analysis (:453-569). From the rotated
stage-1 residual t2rot [S, 16] it builds the four PVQ candidates (K = 6, 8,
10 over 16 or 10 lanes, plus a set-B pulse), normalises them and picks the
shape and gain of least squared error. Every sum is a strict left-to-right
f32 fold, every argmax a strict `>` scan where the first lane wins ties,
and the reference's scan-artifact accumulators carry over between rounds.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .. import tables as T


GAINS = np.zeros((4, 8), dtype=np.float32)  # searched gains per shape, zero-padded
GAINS_N = (1, 3, 3, 7)
for _j, _g in enumerate(T.SNS_GAINS_BY_SHAPE):
    GAINS[_j, : len(_g)] = _g


def _fold(cols):
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    return acc


def sns_pvq_plain(t2rot: torch.Tensor):
    """t2rot [S, 16] f32 -> (y_sel [S, 16] i32, y0s [S, 16] i32, xq_sel
    [S, 16] f32, shape_j [S] i32, gind [S] i32, g_sel [S] f32)."""
    S = t2rot.shape[0]
    dev = t2rot.device
    absx = t2rot.abs()
    ax = [absx[:, n] for n in range(16)]
    lanes = torch.arange(16, device=dev)

    abs_sum = _fold(ax)
    # (6 - 1) / abs_sum, a division as in the oracle and the kernel: `5.0 /
    # abs_sum` would be abs_sum's reciprocal times 5 (Tensor.__rtruediv__)
    proj = torch.full_like(abs_sum, 5.0) / abs_sum
    y3 = torch.floor(absx * proj[:, None]).to(torch.int32)
    y3f = y3.to(torch.float32)
    k0 = y3.sum(1)  # integers: exact in any order
    corr = _fold([y3f[:, n] * ax[n] for n in range(16)])
    energy = _fold([y3f[:, n] * y3f[:, n] for n in range(16)])

    def greedy(y, corr_l, energy_l, corr_art, energy_art, need, n_active):
        yf = y.to(torch.float32)
        cand_corr = corr_l[:, None] + absx
        cand_sq = cand_corr * cand_corr
        cand_en = (energy_l[:, None] + 2.0 * yf) + 1.0
        n_best = torch.zeros(S, dtype=torch.int64, device=dev)
        best_sq, best_en = cand_sq[:, 0], cand_en[:, 0]
        best_abs, best_y = absx[:, 0], yf[:, 0]
        for lane in range(1, n_active):
            better = cand_sq[:, lane] * best_en > best_sq * cand_en[:, lane]
            n_best = torch.where(better, lane, n_best)
            best_sq = torch.where(better, cand_sq[:, lane], best_sq)
            best_en = torch.where(better, cand_en[:, lane], best_en)
            best_abs = torch.where(better, absx[:, lane], best_abs)
            best_y = torch.where(better, yf[:, lane], best_y)
        new_corr = torch.where(need, corr_l + best_abs, corr_l)
        new_energy = torch.where(need, (energy_l + 2.0 * best_y) + 1.0, energy_l)
        corr_art = torch.where(need, cand_corr[:, n_active - 1], corr_art)
        energy_art = torch.where(need, cand_en[:, n_active - 1], energy_art)
        y = torch.where(need[:, None] & (lanes[None, :] == n_best[:, None]), y + 1, y)
        return y, new_corr, new_energy, corr_art, energy_art

    # shape 3: K = 6 pulses; the accumulators start from the projection
    corr_l, energy_l, corr_art, energy_art = corr, energy, corr, energy
    count = k0
    for _ in range(6):
        need = count < 6
        y3, corr_l, energy_l, corr_art, energy_art = greedy(
            y3, corr_l, energy_l, corr_art, energy_art, need, 16)
        count = torch.where(need, count + 1, count)

    # shape 2: two more pulses, seeded from the artifact accumulators
    y2 = y3
    corr_l, energy_l = corr_art, energy_art
    ones = torch.ones(S, dtype=torch.bool, device=dev)
    for _ in range(2):
        y2, corr_l, energy_l, corr_art, energy_art = greedy(
            y2, corr_l, energy_l, corr_art, energy_art, ones, 16)

    # shape 1: strip set B, re-add pulses in set A up to K = 10
    setb = lanes >= 10
    y1 = torch.where(setb[None, :], 0, y2)
    k1 = 8 - torch.where(setb[None, :], y2, 0).sum(1)
    corr_l, energy_l = corr_art, energy_art
    for lane in range(10, 16):
        v = y2[:, lane].to(torch.float32)
        nz = v != 0.0
        corr_l = torch.where(nz, corr_l - v * ax[lane], corr_l)
        energy_l = torch.where(nz, energy_l - v * v, energy_l)
    count = k1
    for _ in range(10):
        need = count < 10
        y1, corr_l, energy_l, corr_art, energy_art = greedy(
            y1, corr_l, energy_l, corr_art, energy_art, need, 10)
        count = torch.where(need, count + 1, count)

    # shape 0: y1 plus one pulse at the largest |x| of set B (first wins)
    nb_best = torch.full((S,), 10, dtype=torch.int64, device=dev)
    b_best = ax[10]
    for lane in range(11, 16):
        better = ax[lane] > b_best
        nb_best = torch.where(better, lane, nb_best)
        b_best = torch.where(better, ax[lane], b_best)
    y0 = torch.where(lanes[None, :] == nb_best[:, None], 1, y1)

    sign = torch.where(t2rot < 0.0, -1, 1).to(torch.int32)
    ys = [y0 * sign, y1 * sign, y2 * sign, y3 * sign]

    def normalize(y, n_active):
        yf = torch.where(lanes[None, :] < n_active, y, 0).to(torch.float32)
        norm = torch.sqrt(_fold([yf[:, n] * yf[:, n] for n in range(16)]))
        return torch.where(yf != 0.0, yf / norm[:, None], yf)

    xq = [normalize(ys[0], 16), normalize(ys[1], 10), normalize(ys[2], 16), normalize(ys[3], 16)]

    # shape/gain search in the order j*8 + g, strict < (the first wins)
    best_mse = None
    shape_j = torch.zeros(S, dtype=torch.int32, device=dev)
    gind = torch.zeros(S, dtype=torch.int32, device=dev)
    g_sel = torch.full((S,), float(GAINS[0, 0]), dtype=torch.float32, device=dev)
    for j in range(4):
        for gi in range(GAINS_N[j]):
            gv = float(GAINS[j, gi])
            diff = t2rot - gv * xq[j]
            mse = _fold([diff[:, n] * diff[:, n] for n in range(16)])
            if best_mse is None:
                best_mse = mse
                continue
            better = mse < best_mse
            best_mse = torch.where(better, mse, best_mse)
            shape_j = torch.where(better, j, shape_j)
            gind = torch.where(better, gi, gind)
            g_sel = torch.where(better, gv, g_sel)

    sel = shape_j.long()[:, None, None].expand(S, 1, 16)
    y_sel = torch.stack(ys, 1).gather(1, sel)[:, 0]
    xq_sel = torch.stack(xq, 1).gather(1, sel)[:, 0]
    return (y_sel.to(torch.int32), ys[0].to(torch.int32), xq_sel, shape_j, gind,
            g_sel.to(torch.float32))


@lru_cache(maxsize=None)
def _gains(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(GAINS, device=device)


def sns_pvq(t2rot: torch.Tensor):
    """SNS stage 2 for any S >= 1 (see sns_pvq_plain for the outputs)."""
    if t2rot.device.type == "cpu":
        return sns_pvq_plain(t2rot)
    if t2rot.device.type != "cuda":
        raise ValueError(f"sns_pvq: unsupported device {t2rot.device}")
    if t2rot.dtype != torch.float32 or t2rot.dim() != 2 or t2rot.shape[1] != 16:
        raise ValueError(f"sns_pvq: t2rot must be float32 [S, 16], got {t2rot.dtype} "
                         f"{tuple(t2rot.shape)}")
    S = t2rot.shape[0]
    x = t2rot.contiguous()
    i32 = torch.int32
    y_sel = x.new_empty((S, 16), dtype=i32)
    y0s = x.new_empty((S, 16), dtype=i32)
    xq_sel = x.new_empty((S, 16))
    shape_j = x.new_empty((S,), dtype=i32)
    gind = x.new_empty((S,), dtype=i32)
    g_sel = x.new_empty((S,))
    _build.launch("lc3t_sns_pvq", x.get_device(), x.data_ptr(), y_sel.data_ptr(), y0s.data_ptr(),
                  xq_sel.data_ptr(), shape_j.data_ptr(), gind.data_ptr(), g_sel.data_ptr(),
                  _gains(x.device).data_ptr(), S)
    return y_sel, y0s, xq_sel, shape_j, gind, g_sel
