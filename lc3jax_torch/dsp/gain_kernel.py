"""Encoder global gain estimate: the CUDA kernel (csrc/gain_estimate.cu) and
its wrapper; the plain PyTorch version is encoder.gain_bisection_plain.

Replaces no `pallas_call`: lc3jax/dsp/encoder.py computes the gain
bisection as XLA glue, which XLA fused into the jitted step on the TPU.
Eager PyTorch ran it as about 13 ops over [S, 256] for each of the ne / 4
energies and 8 gathers after them, 250-1,350 graph nodes in a captured
step; the kernel runs the whole bisection in one launch, a thread a
stream, each fold in the plain version's order (the note in the source
says how).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The wrapper checks every argument on every device, so a CPU caller
meets the same contract.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

F32 = np.float32
# the oracle's constants, folded in f32 (ref/quant.py:_gain_bisection):
# c27 the term below a threshold once one energy was above it, c43 the far
# edge, c36 and c7 the two terms above it
C27, C43, C36, C7 = (float(F32(c) * F32(28.0) / F32(20.0)) for c in (2.7, 43.0, 36.0, 7.0))


def _check(e, nbits_spec_adj, divisor) -> None:
    """Every argument's dtype, shape and device, as the kernel reads them."""
    if e.dtype != torch.float32 or e.dim() != 2 or e.shape[0] < 1 or e.shape[1] < 1:
        raise ValueError(f"gain_estimate: e must be float32 [S, ne/4], "
                         f"got {e.dtype} {tuple(e.shape)}")
    for name, t, shape, dtype in (("nbits_spec_adj", nbits_spec_adj, (e.shape[0],), torch.int64),
                                  ("divisor", divisor, (), torch.float32)):
        if t.device != e.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"gain_estimate: {name} must be {dtype} {shape} on {e.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def gain_estimate(e, nbits_spec_adj, gg_off: int, divisor):
    """The bisection's gain index, int64 [S], before the gain limitation,
    from the 4-line energies e (f32 [S, ne/4], dB), the adjusted bit budget
    (int64 [S]), the gain offset and the divisor tensor of the `gain_estimate`
    site (f32 []). On the card one launch writes it into a fresh tensor and
    reads nothing on the host."""
    _check(e, nbits_spec_adj, divisor)
    if e.device.type == "cpu":
        from .encoder import gain_bisection_plain

        return gain_bisection_plain(e, nbits_spec_adj, gg_off, divisor)
    if e.device.type != "cuda":
        raise ValueError(f"gain_estimate: unsupported device {e.device}")
    e, nbits_spec_adj = (t if t.is_contiguous() else t.contiguous() for t in (e, nbits_spec_adj))
    gg_ind = nbits_spec_adj.new_empty(nbits_spec_adj.shape)
    _build.launch("lc3t_gain_estimate", e.get_device(), e.data_ptr(), nbits_spec_adj.data_ptr(),
                  divisor.data_ptr(), gg_ind.data_ptr(), e.shape[0], e.shape[1], gg_off,
                  C27, C43, C36, C7)
    return gg_ind
