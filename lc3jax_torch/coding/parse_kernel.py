"""Wrapper for the parse kernel (csrc/parse.cu): raw frame bytes on the
card -> ParsedFrames on the card.

Replaces lc3jax/coding/pallas_parse.py:device_parse_pallas and the XLA work
around it; the plain version is coding/device.py:device_parse_plain.

The kernel takes its tables as one byte image that each block copies into
shared memory (`table_image`), and writes the 19 fields into two pooled
buffers, one int32 and one uint8, that `output_views` cuts into the
ParsedFrames fields (bool fields are views of the uint8 one). So a call
checks its input, allocates twice and launches once.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .. import tables as T
from ..config import FrameDuration, Lc3Config
from ..dsp.decoder import ParsedFrames


# The table image, at the byte offsets csrc/parse.cu reads (its k* constants):
# (name, source table, narrow type, byte offset). The cumulative frequency
# rows drop their leading 0 (the kernel takes a symbol's frequency as the
# next entry less its own, 1024 past the last); the TNS order rows are padded
# to 8 entries so that the image, and what follows it in shared memory, stays
# in whole 16-byte words.
TABLE_LAYOUT = (
    ("lookup", T.AC_SPEC_LOOKUP, np.uint8, 0),
    ("spec_cum", np.asarray(T.AC_SPEC_CUMFREQ)[:, 1:], np.uint16, 4096),
    ("coef_cum", np.asarray(T.AC_TNS_COEF_CUMFREQ)[:, 1:], np.uint16, 6144),
    ("order_cum", np.pad(np.asarray(T.AC_TNS_ORDER_CUMFREQ)[:, 1:], ((0, 0), (0, 1))),
     np.uint16, 6400),
    ("mpvq", T.MPVQ_OFFSETS, np.int32, 6432),
)
TABLE_BYTES = 7136

# the [S] fields after the [S, k] ones in each pool, in the order of
# csrc/parse.cu's enum I32Row and enum U8Row
I32_ROWS = ("gg_ind", "bandwidth", "noise_factor", "nf_seed", "n_residual", "sns_shape",
            "sns_gind", "sns_ind_lf", "sns_ind_hf", "pitch_index")
U8_ROWS = ("lsb_mode", "zero_frame", "ltpf_active", "bad_frame")


def table_image() -> np.ndarray:
    """The kernel's tables as one uint8 array of TABLE_BYTES."""
    parts, at = [], 0
    for name, tab, dtype, offset in TABLE_LAYOUT:
        assert at == offset, (name, at, offset)
        narrow = np.asarray(tab).astype(dtype)
        assert np.array_equal(narrow, np.asarray(tab)), name  # nothing lost
        parts.append(narrow.ravel().view(np.uint8))
        at += parts[-1].size
    assert at == TABLE_BYTES, at
    return np.concatenate(parts)


@lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(table_image(), device=device)


def pool_sizes(S: int, ne: int) -> tuple[int, int]:
    """Elements of the int32 and the uint8 pool."""
    return S * (ne + 34 + len(I32_ROWS)), S * (ne + len(U8_ROWS))


def output_views(pool32: torch.Tensor, pool8: torch.Tensor, S: int, ne: int) -> ParsedFrames:
    """ParsedFrames of views into the pools, laid out as csrc/parse.cu
    writes them: int32 x_int [S, ne], rc_order [S, 2], rc_i [S, 16],
    sns_y [S, 16], then one [S] row per I32_ROWS; uint8 residual_bits
    [S, ne], then one [S] row per U8_ROWS; each field C-contiguous, and bool
    where ParsedFrames has bool."""
    x_int, rc_order, rc_i, sns_y, rows = pool32.split_with_sizes(
        [S * ne, 2 * S, 16 * S, 16 * S, len(I32_ROWS) * S])
    res, rows8 = pool8.view(torch.bool).split_with_sizes([S * ne, len(U8_ROWS) * S])
    fields = dict(zip(I32_ROWS, rows.view(len(I32_ROWS), S).unbind(0)))
    fields.update(zip(U8_ROWS, rows8.view(len(U8_ROWS), S).unbind(0)))
    return ParsedFrames(x_int=x_int.view(S, ne), rc_order=rc_order.view(S, 2),
                        rc_i=rc_i.view(S, 16), sns_y=sns_y.view(S, 16),
                        residual_bits=res.view(S, ne), **fields)


def parse_frames_cuda(cfg: Lc3Config, nbytes: int, payloads) -> ParsedFrames:
    """payloads: uint8 [S, nbytes] CUDA tensor -> ParsedFrames (CUDA)."""
    if payloads.device.type != "cuda":
        raise ValueError(f"parse_frames_cuda: payloads must be on a CUDA device, "
                         f"got {payloads.device}")
    if payloads.dtype != torch.uint8 or payloads.dim() != 2 or payloads.shape[1] != nbytes:
        raise ValueError(f"parse_frames_cuda: payloads must be uint8 [S, {nbytes}], "
                         f"got {payloads.dtype} {tuple(payloads.shape)}")
    if not payloads.is_contiguous():
        payloads = payloads.contiguous()
    S, ne = payloads.shape[0], cfg.ne
    n32, n8 = pool_sizes(S, ne)
    pool32 = payloads.new_empty((n32,), dtype=torch.int32)
    pool8 = payloads.new_empty((n8,))
    _build.launch("lc3t_parse", payloads.get_device(), payloads.data_ptr(),
                  _device_tables(payloads.device).data_ptr(), pool32.data_ptr(),
                  pool8.data_ptr(), S, nbytes, ne, cfg.fs_ind,
                  1 if cfg.n_ms == FrameDuration.MS7P5 else 0)
    return output_views(pool32, pool8, S, ne)
