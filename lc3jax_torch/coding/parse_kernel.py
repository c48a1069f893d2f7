"""Wrapper for the parse kernel (csrc/parse.cu): raw frame bytes on the
card -> ParsedFrames on the card.

Replaces lc3jax/coding/pallas_parse.py:device_parse_pallas and the XLA work
around it; the plain version is coding/device.py:device_parse_plain.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .. import tables as T
from ..config import FrameDuration, Lc3Config
from ..dsp.decoder import BOOL_FRAME_FIELDS, ParsedFrames

launches = 0  # kernel launches since the last reset

# int32 table buffer, in the order and at the offsets csrc/parse.cu expects
_TABLE_ORDER = (
    ("spec_cum", T.AC_SPEC_CUMFREQ, 0), ("spec_freq", T.AC_SPEC_FREQ, 1088),
    ("lookup", T.AC_SPEC_LOOKUP, 2176), ("order_cum", T.AC_TNS_ORDER_CUMFREQ, 6272),
    ("order_freq", T.AC_TNS_ORDER_FREQ, 6288), ("coef_cum", T.AC_TNS_COEF_CUMFREQ, 6304),
    ("coef_freq", T.AC_TNS_COEF_FREQ, 6440), ("mpvq", T.MPVQ_OFFSETS, 6576),
)
TABLE_WORDS = 6752


def table_buffer() -> np.ndarray:
    parts, at = [], 0
    for name, tab, offset in _TABLE_ORDER:
        assert at == offset, (name, at, offset)
        flat = np.asarray(tab, np.int64).ravel()
        parts.append(flat)
        at += flat.size
    assert at == TABLE_WORDS, at
    return np.concatenate(parts).astype(np.int32)


@lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(table_buffer(), device=device)


def parse_frames_cuda(cfg: Lc3Config, nbytes: int, payloads) -> ParsedFrames:
    """payloads: uint8 [S, nbytes] CUDA tensor -> ParsedFrames (CUDA)."""
    global launches
    if payloads.device.type != "cuda":
        raise ValueError(f"parse_frames_cuda: payloads must be on a CUDA device, "
                         f"got {payloads.device}")
    if payloads.dtype != torch.uint8 or payloads.dim() != 2 or payloads.shape[1] != nbytes:
        raise ValueError(f"parse_frames_cuda: payloads must be uint8 [S, {nbytes}], "
                         f"got {payloads.dtype} {tuple(payloads.shape)}")
    dev = payloads.device
    payloads = payloads.contiguous()
    S, ne = payloads.shape[0], cfg.ne
    shapes = {"x_int": (S, ne), "rc_order": (S, 2), "rc_i": (S, 16),
              "residual_bits": (S, ne), "sns_y": (S, 16)}
    out = {
        f.name: torch.empty(shapes.get(f.name, (S,)), device=dev,
                            dtype=torch.bool if f.name in BOOL_FRAME_FIELDS else torch.int32)
        for f in dataclasses.fields(ParsedFrames)
    }
    save_lev = torch.empty((ne // 2, S), dtype=torch.int32, device=dev)
    tab = _device_tables(dev)
    ptrs = [out[f.name].data_ptr() for f in dataclasses.fields(ParsedFrames)]
    with torch.cuda.device(dev):
        err = _build.lib().lc3t_parse(
            payloads.data_ptr(), tab.data_ptr(), save_lev.data_ptr(), *ptrs,
            S, nbytes, ne, cfg.fs_ind, 1 if cfg.n_ms == FrameDuration.MS7P5 else 0,
            _build.stream_ptr(dev),
        )
    _build.check(err, "lc3t_parse")
    launches += 1
    return ParsedFrames(**out)
