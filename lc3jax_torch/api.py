"""Reference-parity facade (the port of lc3jax/api.py).

Mirrors the reference public API surface (encoder/lc3_encoder.rs:115-209,
decoder/lc3_decoder.rs:180-244): `Lc3Encoder` / `Lc3Decoder` with
per-channel `encode_frame` / `decode_frame`, and the
`calc_working_buffer_lengths` const calculators. The calculators are config
arithmetic: they return exactly the reference's buffer element counts, and
`decoder_ram_bytes` reproduces the published 27,564-byte figure (reference
README.md:130); the port's own buffers are its tensors.

lc3jax backs the facade with its oracle (`lc3jax.ref`); here each channel
is one serving coder at S = 1 on the card (`serving.BatchEncoder` in its
host-pack mode, `serving.BatchDecoder` in its device-parse mode), made at
the channel's first call. The facade is for parity, not throughput: a
frame costs one replayed S = 1 step and one fetch to the host. Batch
streams through `serving.BatchEncoder` / `serving.BatchDecoder` instead.
It runs on the card unless the caller passes device="cpu"; without a card
the default raises.
"""

from __future__ import annotations

import numpy as np

from .config import FrameDuration, Lc3Config, SamplingFrequency
from .devices import resolve_device
from .serving import BatchDecoder, BatchEncoder

__all__ = [
    "Lc3Encoder",
    "Lc3Decoder",
    "FrameDuration",
    "SamplingFrequency",
    "Lc3Config",
    "encoder_calc_working_buffer_lengths",
    "decoder_calc_working_buffer_lengths",
    "decoder_ram_bytes",
]


class Lc3Encoder:
    """`encode_frame(channel_index, samples_in, nbytes) -> bytes` per channel
    (encoder/lc3_encoder.rs:115-209), each channel its own stream."""

    def __init__(self, num_channels: int, frame_duration: FrameDuration,
                 sampling_frequency: SamplingFrequency | int, device="cuda"):
        self.config = Lc3Config.new(sampling_frequency, frame_duration)
        self.device = resolve_device(device)
        self.channels: list[BatchEncoder | None] = [None] * num_channels

    def encode_frame(self, channel_index: int, samples_in, nbytes: int) -> bytes:
        """int16 PCM [nf] (coerced, as lc3jax/ref/encoder.py:75-77 does) ->
        one frame of exactly nbytes; nbytes may change from call to call."""
        pcm = np.array(samples_in, dtype=np.int16).reshape(1, self.config.nf)
        coder = self.channels[channel_index]
        if coder is None:
            coder = self.channels[channel_index] = BatchEncoder(self.config, 1, nbytes,
                                                                self.device)
        return coder.encode(pcm, nbytes)[0].tobytes()


class Lc3Decoder:
    """`decode_frame(num_bits_per_audio_sample, channel_index, buf_in) ->
    int16 [nf]` per channel (decoder/lc3_decoder.rs:180-244), each channel
    its own stream. A corrupt, truncated or empty frame is concealed."""

    def __init__(self, num_channels: int, frame_duration: FrameDuration,
                 sampling_frequency: SamplingFrequency | int, device="cuda"):
        self.config = Lc3Config.new(sampling_frequency, frame_duration)
        self.device = resolve_device(device)
        self.channels: list[BatchDecoder | None] = [None] * num_channels

    def decode_frame(self, num_bits_per_audio_sample: int, channel_index: int,
                     buf_in) -> np.ndarray:
        if num_bits_per_audio_sample != 16:
            raise ValueError("only 16 bits per audio sample supported")
        payload = np.frombuffer(bytes(buf_in), np.uint8)[None]
        coder = self.channels[channel_index]
        if coder is None:
            coder = self.channels[channel_index] = BatchDecoder(
                self.config, 1, payload.shape[1], self.device)
        return coder.decode(payload)[0]


def _ltpf_dec_lengths(cfg: Lc3Config) -> dict:
    l_den = {8000: 4, 16000: 4, 24000: 6, 32000: 8, 44100: 11, 48000: 12}[cfg.fs]
    l_num = l_den - 2
    if cfg.n_ms == FrameDuration.MS10:
        num_mem, norm = 2, cfg.nf // 4
    else:
        num_mem, norm = 3, cfg.nf // 3
    return dict(
        c_num=l_num + 1,
        c_den=l_den + 1,
        mems=2 * num_mem * cfg.nf,
        scratch=l_num + norm,
    )


def decoder_calc_working_buffer_lengths(
    num_channels: int,
    frame_duration: FrameDuration,
    sampling_frequency: SamplingFrequency | int,
) -> tuple[int, int]:
    """(scaler_len, complex_len) exactly as the reference const fn
    (decoder/lc3_decoder.rs:156-162, 236-244)."""
    cfg = Lc3Config.new(sampling_frequency, frame_duration)
    dct_scaler = cfg.nf // 2 + (cfg.nf - cfg.ne) + (cfg.nf - cfg.z) + 2 * cfg.nf + cfg.nf
    dct_complex = cfg.nf // 2 * 4
    plc = cfg.ne
    lt = _ltpf_dec_lengths(cfg)
    ltpf = lt["c_den"] * 3 + lt["c_num"] * 2 + lt["mems"] + lt["scratch"]
    scaler = cfg.ne + plc + dct_scaler + ltpf
    return num_channels * scaler, num_channels * dct_complex


def decoder_ram_bytes(
    num_channels: int,
    frame_duration: FrameDuration,
    sampling_frequency: SamplingFrequency | int,
) -> int:
    """Working-buffer bytes (f32 scaler + 8-byte Complex)."""
    s, c = decoder_calc_working_buffer_lengths(num_channels, frame_duration, sampling_frequency)
    return 4 * s + 8 * c


def encoder_calc_working_buffer_lengths(
    num_channels: int,
    frame_duration: FrameDuration,
    sampling_frequency: SamplingFrequency | int,
) -> tuple[int, int, int]:
    """(integer_len, scaler_len, complex_len) as the reference const fn
    (encoder/lc3_encoder.rs:193-209)."""
    cfg = Lc3Config.new(sampling_frequency, frame_duration)
    if cfg.n_ms == FrameDuration.MS10:
        len12, delay = 128, 24
    else:
        len12, delay = 96, 44
    up = {8000: 24, 16000: 12, 24000: 8, 32000: 6, 44100: 4, 48000: 4}[cfg.fs]
    x_s_ext = 240 // up + cfg.nf
    x12_len = len12 + delay + 232
    x64_len = 64 + 114
    integer = 2 * cfg.nf + x_s_ext + cfg.ne
    scaler = x12_len + x64_len + cfg.nf + cfg.nb
    complex_len = cfg.nf // 2 * 4
    return (
        num_channels * integer,
        num_channels * scaler,
        num_channels * complex_len,
    )
