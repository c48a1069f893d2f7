"""Float32 helpers that pin the oracle's arithmetic (what the port needs of
lc3jax/ref/fp.py, adapted to run without the host's libm).

The oracle (`lc3jax.ref`) does its float math in f32, folds sums strictly
left to right and calls glibc for transcendentals. The port may run on
another host than the one that made the goldens, and on the card, so it
calls no libm:

- `powf`: the tables that need it (global gain, SNS pre-emphasis) are made
  once, in float64 and rounded to f32. For every argument the codec uses
  this equals glibc's powf (tests/test_torch_encoder.py checks them all).
- `log10f`, `log2f`, `asinf` on tensors: float64, then one rounding to f32.
  glibc's log10f and asinf are not correctly rounded, so these differ from
  the oracle by one ulp on a few percent of arguments; the values they feed
  are compared against thresholds or rounded to integers, and the encoder
  stays byte-exact on the corpus (tests/test_torch_encoder.py, chip_smoke.py).
- `seq_fold`: the oracle's left-to-right f32 sum. `torch.sum` and
  `torch.cumsum` reduce in another order on the CPU and on CUDA, and the
  oracle's knife edges (quantizer, PVQ search) see the difference.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def powf(x, y) -> np.float32:
    """f32 x**y, computed in float64 and rounded once."""
    return F32(np.float64(F32(x)) ** np.float64(F32(y)))


def _via_f64(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.to(torch.float64)).to(torch.float32)


def log10f(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.log10, x)


def log2f(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.log2, x)


def asinf(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.asin, x)


def seq_fold(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Strict left-to-right f32 sum over `dim`: one add per element, in order."""
    xs = x.movedim(dim, 0)
    acc = xs[0]
    for i in range(1, xs.shape[0]):
        acc = acc + xs[i]
    return acc
