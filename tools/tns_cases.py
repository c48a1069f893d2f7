"""Inputs of the TNS coefficient kernel that reach its edge cases.

`coef_rows` is shared by `chip_smoke.py` (phase 9, on the card) and
`tests/test_torch_tns_enc.py` (the plain version on the CPU); it needs
numpy only.
"""

from __future__ import annotations

import numpy as np


def coef_rows(cfg, S: int, seed: int) -> tuple:
    """TNS coefficient inputs at cfg (numpy): x [S, ne] f32 in eight kinds by
    stream mod 8: white noise at scales 1-1000; AR(1) rows with rho in
    0.45-0.85; AR(1) rows with rho near the prediction gains 1.5 and 2.0;
    all zero (es = 0); tiny rows (1e-15: each es nonzero, their product
    underflows to 0); AR(1) with a stretch of filter 0's first sub-block
    zero; AR(1) with rho < 0; tones. Bandwidths 0 .. the config's own (the
    first ten streams cycle through them), near_nyquist on every fifth
    stream. Returns x, bw_ind, near_nyquist."""
    rng = np.random.default_rng(seed)
    ne = cfg.ne
    kind = np.arange(S) % 8
    w = rng.standard_normal((S, ne))
    rho = np.select([kind == 1, kind == 2, kind == 5, kind == 6],
                    [rng.uniform(0.45, 0.85, S), rng.choice([0.574, 0.58, 0.704, 0.71], S),
                     rng.uniform(0.5, 0.9, S), -rng.uniform(0.45, 0.8, S)], 0.0)
    ar = np.zeros((S, ne))
    for n in range(ne):
        ar[:, n] = rho * (ar[:, n - 1] if n else 0.0) + w[:, n]
    scale = 10 ** rng.uniform(0, 3, (S, 1))
    tone = 1000 * np.sin(rng.uniform(0.1, 3.0, (S, 1)) * np.arange(ne)) + w
    x = np.select([kind[:, None] == 0, kind[:, None] == 3, kind[:, None] == 4, kind[:, None] == 7],
                  [w * scale, 0.0, w * 1e-15, tone], ar * scale)
    x[kind == 5, ne // 40 : ne // 5] = 0.0
    bw = rng.integers(0, cfg.fs_ind + 1, S)
    bw[:10] = (np.arange(10) % (cfg.fs_ind + 1))[:S]
    return x.astype(np.float32), bw.astype(np.int32), np.arange(S) % 5 == 0
