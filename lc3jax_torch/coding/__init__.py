"""Bitstream parsing on tensors (port of lc3jax/coding/device.py)."""
