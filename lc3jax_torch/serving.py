"""Serving entry point: batched decode of raw frame bytes (port of the
device-parse mode of lc3jax/serving.py:BatchDecoder).

One call decodes one frame for each of n_streams streams: the parse kernel,
the spectral DSP, TNS, the IMDCT and the LTPF all run on `device` with no
host work per batch beyond the copy of the payloads in and the PCM out.
"""

from __future__ import annotations

import numpy as np
import torch

from lc3jax.config import Lc3Config
from lc3jax.metrics import CodecMetrics

from .coding.device import decode_bytes_step_stats
from .dsp.decoder import DecoderState, decoder_init


class BatchDecoder:
    """Decodes batches of [n_streams] frames per call.

    payloads: uint8 [S, nbytes] (one frame per stream). Returns int16 PCM
    [S, nf]. Corrupt frames are concealed (PLC) per stream."""

    def __init__(self, cfg: Lc3Config, n_streams: int, nbytes: int, device="cpu"):
        self.cfg = cfg
        self.n_streams = n_streams
        self.nbytes = nbytes
        self.device = torch.device(device)
        self.state: DecoderState = decoder_init(cfg, n_streams, self.device)
        self.metrics = CodecMetrics()
        self._frame_seconds = cfg.nf / cfg.fs

    def decode_tensor(self, payloads: torch.Tensor) -> torch.Tensor:
        """uint8 [S, nbytes] tensor on the decoder's device -> int16 [S, nf]
        tensor on the same device. nbytes may differ per call (variable
        bitrate mid-stream, state preserved)."""
        if payloads.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got {payloads.shape[0]}")
        self.state, pcm, n_bad = decode_bytes_step_stats(
            self.cfg, payloads.shape[1], self.state, payloads
        )
        # the concealed-frame count keeps plc_rate observable on the fused path
        self.metrics.record_decode(self.n_streams, self._frame_seconds, n_bad=int(n_bad))
        return pcm

    def decode(self, payloads: np.ndarray) -> np.ndarray:
        """payloads uint8 [S, nbytes] (host) -> int16 PCM [S, nf] (host)."""
        buf = torch.as_tensor(np.ascontiguousarray(payloads, np.uint8)).to(self.device)
        return self.decode_tensor(buf).cpu().numpy()
