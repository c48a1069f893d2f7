"""Bit-exact glibc exp2f on tensors (port of lc3jax/dsp/libmexact.py).

The encoder shapes the spectrum with exp2 of the interpolated scale factors
(spectral_noise_shaping.rs:254-270), and the oracle calls glibc's exp2f for
it. A plain exp2 differs from glibc by 1-4 ulps on most inputs, which
flips quantizer and residual knife edges. This module reproduces glibc's
algorithm (sysdeps/ieee754/flt-32/e_exp2f.c): a 32-entry float64 table, a
magic-number rounding and a cubic polynomial, all in float64, rounded once
to f32. The card has IEEE float64, so the same code runs on the CPU and on
CUDA; eager PyTorch rounds every op, so nothing is contracted into fma.

The table, the shift and the polynomial are stored in
`lc3jax_torch/data/exp2f.npz`, extracted once from the glibc the oracle
ran against (tools/gen_torch_encode_goldens.py). The port never scans the
libm of the host it runs on: the card's host may have another glibc.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parent.parent / "data" / "exp2f.npz"


@lru_cache(maxsize=1)
def _host_table() -> tuple[np.ndarray, float, tuple[float, float, float]]:
    d = np.load(DATA)
    tab = np.asarray(d["tab"], np.uint64)
    poly = tuple(float(v) for v in np.asarray(d["poly"], np.float64))
    return tab, float(d["shift"]), poly


@lru_cache(maxsize=None)
def _table(device: torch.device) -> torch.Tensor:
    tab = _host_table()[0]
    # the entries are below 2^63, so their int64 view is the same bits
    return torch.as_tensor(tab.view(np.int64).copy(), device=device)


def exp2f(x: torch.Tensor) -> torch.Tensor:
    """glibc exp2f on an f32 tensor, |x| < 128 (LC3 scale factors span
    about [-17, 17])."""
    _, shift, (p0, p1, p2) = _host_table()
    tab = _table(x.device)
    xd = x.to(torch.float64)
    kd = xd + shift  # keeps only the 1/32-grid part of x in the mantissa
    ki = kd.view(torch.int64)
    kd = kd - shift
    r = xd - kd
    # uint64 arithmetic of the C code; int64 wraps to the same bits
    t = tab[ki & 31] + (ki << 47)
    s = t.view(torch.float64)
    z = p0 * r + p1
    r2 = r * r
    y = p2 * r + 1.0
    y = z * r2 + y
    y = y * s
    return y.to(torch.float32)
