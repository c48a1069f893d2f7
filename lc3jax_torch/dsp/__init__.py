"""Batched decoder DSP on tensors (port of lc3jax/dsp)."""
