"""The yardstick of the kernels' roofline shares: the least bytes a kernel's
work needs, counted from the configuration and the stream count alone
(never from the program's buffers), and the card's published peaks
(`peaks.json`, by `torch.cuda.get_device_name()`).

An LC3 frame's coded fields, each at the narrowest width that holds it:
the ne spectral lines as int16 (|x_q| <= 32767), one residual bit a
line, 44 side values as int16 (global gain, bandwidth, noise factor,
noise-filling seed, residual count, two TNS orders and 16 TNS
coefficients, 16 SNS pulses, the SNS shape, gain and two indices, the
pitch index) and 4 flags as bits (LSB mode, zero frame, LTPF active, bad
frame). The parse kernel reads each frame byte once and writes each field
once; the pack kernel reads each field once and writes each frame byte
once. Both are range coders, serial within a frame, so the byte bound
says how far they are from the memory system, not from their chain.
"""

from __future__ import annotations

import json

from .reference import lc3_config
from .spec import HERE

SIDE_VALUES = 44
FLAG_BITS = 4


def field_bytes(cfg: dict) -> float:
    """Bytes of one frame's coded fields (see the module's docstring)."""
    ne = lc3_config(cfg).ne
    return 2 * ne + ne / 8 + 2 * SIDE_VALUES + FLAG_BITS / 8


def coder_bytes(cfg: dict, streams: int) -> float:
    """Bytes the parse kernel, or the pack kernel, moves for one batch."""
    return streams * (cfg["nbytes"] + field_bytes(cfg))


def peaks(device_name: str) -> dict | None:
    with open(HERE / "peaks.json") as f:
        return json.load(f).get(device_name)


def roofline_pct(bytes_moved: float, kernel_ms: float, device_name: str) -> float | None:
    """The least time for `bytes_moved` at the card's memory bandwidth over
    the kernel's time, in percent (None for a card not in peaks.json)."""
    p = peaks(device_name)
    if p is None or not kernel_ms:
        return None
    return 100.0 * (bytes_moved / p["hbm_bytes_per_s"] * 1e3) / kernel_ms
