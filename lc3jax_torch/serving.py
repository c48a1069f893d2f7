"""Serving entry points: batched decode of raw frame bytes and batched
encode of PCM (ports of lc3jax/serving.py:BatchDecoder in its device-parse
mode and BatchEncoder in its host-pack and device-pack modes).

Both run on the card unless the caller passes device="cpu"; where no card
is present, the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .coding import host_pack
from .coding.device import decode_bytes_step_stats, encode_bytes_step
from .config import Lc3Config
from .convert import encoder_fields_to_numpy
from .devices import resolve_device
from .dsp.decoder import DecoderState, decoder_init
from .dsp.encoder import EncoderState, encode_step, encoder_init
from .metrics import CodecMetrics


class BatchDecoder:
    """Decodes batches of [n_streams] frames per call.

    payloads: uint8 [S, nbytes] (one frame per stream). Returns int16 PCM
    [S, nf]. Corrupt frames are concealed (PLC) per stream."""

    def __init__(self, cfg: Lc3Config, n_streams: int, nbytes: int, device="cuda"):
        self.cfg = cfg
        self.n_streams = n_streams
        self.nbytes = nbytes
        self.device = resolve_device(device)
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


class BatchEncoder:
    """Encodes batches of [n_streams, nf] int16 PCM into frames.

    device_pack=False: the analysis DSP on the device, the range coder on
    the host (the C++ packer). device_pack=True: PCM in, frame bytes out,
    all on the device (encode_bytes_step: the DSP, then the pack kernel), no
    host work per batch but fetching the bytes."""

    def __init__(self, cfg: Lc3Config, n_streams: int, nbytes: int, device="cuda",
                 device_pack: bool = False):
        self.cfg = cfg
        self.n_streams = n_streams
        self.nbytes = nbytes
        self.device_pack = device_pack
        self.device = resolve_device(device)
        self.state: EncoderState = encoder_init(cfg, n_streams, self.device)
        self.metrics = CodecMetrics()
        self._frame_seconds = cfg.nf / cfg.fs

    def _check(self, pcm) -> None:
        if tuple(pcm.shape) != (self.n_streams, self.cfg.nf):
            raise ValueError(f"expected PCM [{self.n_streams}, {self.cfg.nf}], "
                             f"got {tuple(pcm.shape)}")

    def encode_fields_tensor(self, pcm: torch.Tensor, nbytes: int | None = None) -> dict:
        """int16 [S, nf] tensor on the encoder's device -> the bitstream
        fields, tensors on the same device (the names of encode_step)."""
        self._check(pcm)
        nbytes = self.nbytes if nbytes is None else nbytes
        self.state, fields = encode_step(self.cfg, nbytes, self.state, pcm)
        return fields

    def encode_tensor(self, pcm: torch.Tensor, nbytes: int | None = None) -> torch.Tensor:
        """int16 [S, nf] tensor on the encoder's device -> uint8 [S, nbytes]
        frames on the same device (device_pack mode; the twin of
        BatchDecoder.decode_tensor)."""
        if not self.device_pack:
            raise ValueError("encode_tensor needs BatchEncoder(..., device_pack=True)")
        self._check(pcm)
        nbytes = self.nbytes if nbytes is None else nbytes
        self.state, payloads = encode_bytes_step(self.cfg, nbytes, self.state, pcm)
        self.metrics.record_encode(self.n_streams, self._frame_seconds)
        return payloads

    def encode(self, pcm: np.ndarray, nbytes: int | None = None) -> np.ndarray:
        """pcm int16 [S, nf] (host) -> uint8 [S, nbytes] (host). nbytes may
        change per call (variable bitrate mid-stream, state preserved: the
        encoder state does not depend on it)."""
        nbytes = self.nbytes if nbytes is None else nbytes
        x = torch.as_tensor(np.ascontiguousarray(pcm, np.int16)).to(self.device)
        if self.device_pack:
            return self.encode_tensor(x, nbytes).cpu().numpy()
        fields = encoder_fields_to_numpy(self.encode_fields_tensor(x, nbytes))
        self.metrics.record_encode(self.n_streams, self._frame_seconds)
        return host_pack.pack_frames(self.cfg, fields, nbytes)
