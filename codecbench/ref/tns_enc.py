"""TNS analysis: lag-windowed autocorrelation, Levinson-Durbin, reflection
coefficient quantization and lattice analysis filtering (reference
encoder/temporal_noise_shaping.rs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as T
from .config import FrameDuration, Lc3Config
from . import fp
from .fp import seq_sum

F32 = np.float32

LAG_WINDOW = np.array(
    [
        1.0,
        0.9980280260203829,
        0.9921354055113971,
        0.9823915844707989,
        0.9689107911912967,
        0.9518498073692735,
        0.9314049334023056,
        0.9078082299969592,
        0.8813231366694713,
    ],
    dtype=F32,
)

# (num_filters, start_freq, stop_freq, sub_start, sub_stop) per (n_ms, p_bw)
_PARAMS_10MS = [
    (1, [12, 160], [80, 0], [[12, 34, 57], [0, 0, 0]], [[34, 57, 80], [0, 0, 0]]),
    (1, [12, 160], [160, 0], [[12, 61, 110], [0, 0, 0]], [[61, 110, 160], [0, 0, 0]]),
    (1, [12, 160], [200, 0], [[12, 88, 164], [0, 0, 0]], [[88, 164, 240], [0, 0, 0]]),
    (2, [12, 160], [160, 320], [[12, 61, 110], [160, 213, 266]], [[61, 110, 160], [213, 266, 320]]),
    (2, [12, 200], [200, 400], [[12, 74, 137], [200, 266, 333]], [[74, 137, 200], [266, 333, 400]]),
]
_PARAMS_7P5MS = [
    (1, [9, 120], [60, 0], [[9, 26, 43], [0, 0, 0]], [[26, 43, 60], [0, 0, 0]]),
    (1, [9, 120], [120, 0], [[9, 46, 83], [0, 0, 0]], [[46, 83, 120], [0, 0, 0]]),
    (1, [9, 120], [180, 0], [[9, 66, 123], [0, 0, 0]], [[66, 123, 180], [0, 0, 0]]),
    (2, [9, 120], [120, 240], [[9, 46, 82], [120, 159, 200]], [[46, 82, 120], [159, 200, 240]]),
    (2, [9, 150], [150, 300], [[9, 56, 103], [150, 200, 250]], [[56, 103, 150], [200, 250, 300]]),
]


@dataclass
class TnsResult:
    nbits_tns: int
    lpc_weighting: int
    num_tns_filters: int
    rc_order: list
    rc_i: list
    rc_q: np.ndarray


def tns_encode(
    cfg: Lc3Config, x: np.ndarray, p_bw: int, nbits: int, near_nyquist: bool
) -> TnsResult:
    params = (_PARAMS_10MS if cfg.n_ms == FrameDuration.MS10 else _PARAMS_7P5MS)[p_bw]
    num_filters, start_freq, stop_freq, sub_start, sub_stop = params

    if cfg.n_ms == FrameDuration.MS10:
        lpc_weighting = 1 if nbits < 480 else 0
    else:
        lpc_weighting = 1 if nbits < 360 else 0

    rc_q = np.zeros(16, dtype=F32)
    rc_i = [0] * 16
    rc_order = [0, 0]

    for f in range(num_filters):
        r = _autocorrelation(sub_start[f], sub_stop[f], x)
        _analysis(r, f, near_nyquist, lpc_weighting, rc_q)

    # quantization: asin-domain uniform quantizer, 17 steps
    step = F32(np.pi / 17.0)
    for f in range(num_filters):
        for k in range(8):
            q = fp.asinf(rc_q[f * 8 + k]) / step
            i = int(q + F32(0.5)) if q >= 0.0 else -int(-q + F32(0.5))
            rc_i[f * 8 + k] = i + 8
            rc_q[f * 8 + k] = fp.sinf(step * (F32(rc_i[f * 8 + k]) - F32(8.0)))
        k = 7
        while k >= 0 and rc_i[f * 8 + k] == 8:
            k -= 1
        rc_order[f] = k + 1
    for f in range(num_filters, 2):
        for k in range(8):
            rc_i[f * 8 + k] = 8
            rc_q[f * 8 + k] = F32(0.0)
        rc_order[f] = 0

    # bit budget with the arithmetic coder's table costs
    nbits_tns = 0
    for f in range(num_filters):
        nb_order = (
            int(T.AC_TNS_ORDER_BITS[lpc_weighting][rc_order[f] - 1]) if rc_order[f] != 0 else 0
        )
        nb_coef = 0
        for k in range(rc_order[f]):
            nb_coef += int(T.AC_TNS_COEF_BITS[k][rc_i[f * 8 + k]])
        nbits_tns += int(np.ceil((F32(2048.0) + F32(nb_order) + F32(nb_coef)) / F32(2048.0)))

    # lattice analysis filtering in place
    st = np.zeros(8, dtype=F32)
    for f in range(num_filters):
        if rc_order[f] != 0:
            frm, to = start_freq[f], stop_freq[f]
            prev_order = rc_order[f] - 1
            for n in range(frm, to):
                t = x[n]
                st_save = t
                for k in range(prev_order):
                    rcq = rc_q[f * 8 + k]
                    st_tmp = rcq * t + st[k]
                    t = t + rcq * st[k]
                    st[k] = st_save
                    st_save = st_tmp
                t = t + rc_q[f * 8 + prev_order] * st[prev_order]
                st[prev_order] = st_save
                x[n] = t

    return TnsResult(
        nbits_tns=nbits_tns,
        lpc_weighting=lpc_weighting,
        num_tns_filters=num_filters,
        rc_order=rc_order,
        rc_i=rc_i,
        rc_q=rc_q,
    )


def _autocorrelation(sub_start, sub_stop, x: np.ndarray) -> np.ndarray:
    """Lag-windowed normalized autocorrelation over 3 sub-blocks, order 8."""
    r = np.zeros(9, dtype=F32)
    for k in range(9):
        r0 = F32(3.0) if k == 0 else F32(0.0)
        rk = F32(0.0)
        e_prod = F32(1.0)
        for start, stop in zip(sub_start, sub_stop):
            es = seq_sum(x[start:stop] * x[start:stop])
            k_from = start + k
            if k_from < len(x) and k_from < stop:
                ac = seq_sum(x[start : stop - k] * x[k_from:stop])
            else:
                ac = F32(0.0)
            e_prod = e_prod * es
            with np.errstate(divide="ignore", invalid="ignore"):
                rk = rk + ac / es  # es==0 yields inf/nan, discarded below
        r[k] = (rk if e_prod != 0.0 else r0) * LAG_WINDOW[k]
    return r


def _analysis(r, f, near_nyquist, lpc_weighting, rc_q):
    """Levinson-Durbin -> LPC; prediction-gain gate; LPC -> reflection coefs."""
    a = np.zeros(9, dtype=F32)
    a_last = np.zeros(9, dtype=F32)
    e = r[0]
    a[0] = F32(1.0)
    for k in range(1, 9):
        a, a_last = a_last, a
        rc = F32(0.0)
        for n in range(k):
            rc = rc - a_last[n] * r[k - n]
        if e != 0.0:
            rc = rc / e
        a[0] = F32(1.0)
        for n in range(1, k):
            a[n] = a_last[n] + rc * a_last[k - n]
        a[k] = rc
        e = e * (F32(1.0) - rc * rc)

    pred_gain = r[0] if e == 0.0 else r[0] / e
    if pred_gain > F32(1.5) and not near_nyquist:
        gamma = F32(1.0)
        if lpc_weighting > 0 and pred_gain < F32(2.0):
            gamma = gamma - (F32(1.0) - F32(0.85)) * (F32(2.0) - pred_gain) / (
                F32(2.0) - F32(1.5)
            )
        # a[k] *= gamma^k via f32 powi (binary exponentiation)
        for k in range(9):
            a[k] = a[k] * _powi(gamma, k)
        # LPC -> reflection coefficients (inverse Levinson)
        a_k = a
        a_km1 = a_last
        rc = rc_q[f * 8 :]
        for k in range(8, 0, -1):
            rc[k - 1] = a_k[k]
            e = F32(1.0) - rc[k - 1] * rc[k - 1]
            for n in range(1, k):
                a_km1[n] = a_k[n] - rc[k - 1] * a_k[k - n]
                a_km1[n] = a_km1[n] / e
            a_k, a_km1 = a_km1, a_k
    else:
        rc_q[f * 8 : f * 8 + 8] = F32(0.0)


def _powi(x: np.float32, n: int) -> np.float32:
    """f32 x^n by binary exponentiation (LLVM powi semantics)."""
    result = F32(1.0)
    base = F32(x)
    while n > 0:
        if n & 1:
            result = result * base
        base = base * base
        n >>= 1
    return result
