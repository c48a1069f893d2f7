"""Reference-exact LC3 encoder (host oracle).

API mirrors the reference Lc3Encoder (encoder/lc3_encoder.rs:115-209):
per-channel streaming state; `encode_frame(channel, samples[nf], nbytes) ->
bytes`. Stage order matches EncoderChannel::encode (lc3_encoder.rs:63-112).
"""

from __future__ import annotations

import numpy as np

from .config import FrameDuration, Lc3Config, SamplingFrequency
from .bitstream_enc import BitstreamEncoder
from .encoder_stages import (
    AttackDetector,
    BandwidthDetector,
    noise_level_estimation,
    residual_bits_encode,
)
from .ltpf_enc import LtpfEncoder
from .mdct_enc import ForwardMdct
from .quant import SpectralQuantizer
from .sns_enc import SpectralNoiseShapingEncoder
from .tns_enc import tns_encode

F32 = np.float32


class _Channel:
    def __init__(self, cfg: Lc3Config, round_to=None):
        self.cfg = cfg
        self.round_to = round_to
        self.mdct = ForwardMdct(cfg)
        self.bandwidth = BandwidthDetector(cfg)
        self.attack = AttackDetector(cfg)
        self.sns = SpectralNoiseShapingEncoder(cfg)
        self.ltpf = LtpfEncoder(cfg)
        self.quant = SpectralQuantizer(cfg.ne, cfg.fs_ind)
        self.bitstream = BitstreamEncoder(cfg.ne)

    def encode(self, x_s: np.ndarray, nbytes: int) -> bytes:
        cfg = self.cfg
        nbits = nbytes * 8

        spec, energy_bands, near_nyquist = self.mdct.run(x_s)
        x = spec[: cfg.ne]
        self._round(x)
        self._round(energy_bands)

        bw_ind, nbits_bw = self.bandwidth.run(energy_bands)
        attack_detected = self.attack.run(x_s, nbytes)
        sns = self.sns.run(x, energy_bands, attack_detected)
        self._round(x)
        tns = tns_encode(cfg, x, bw_ind, nbits, near_nyquist)
        self._round(x)
        ltpf = self.ltpf.run(x_s, near_nyquist, nbits)

        x_q = np.zeros(cfg.ne, dtype=np.int16)
        quant = self.quant.run(x, x_q, nbits, nbits_bw, tns.nbits_tns, ltpf.nbits_ltpf)
        residual = residual_bits_encode(
            quant.nbits_spec, quant.nbits_trunc, cfg.ne, quant.gg, x, x_q
        )
        noise_factor = noise_level_estimation(cfg, x, x_q, bw_ind, quant.gg)

        return self.bitstream.encode(
            bw_ind, nbits_bw, sns, tns, ltpf, quant, residual, noise_factor, x_q, nbytes
        )

    def _round(self, x: np.ndarray) -> None:
        """Rounds a stage's float32 output in place to a lower precision
        (the benchmark's control); nothing in float32."""
        if self.round_to is not None:
            x[:] = self.round_to(x)


class Lc3Encoder:
    def __init__(
        self,
        num_channels: int,
        frame_duration: FrameDuration,
        sampling_frequency: SamplingFrequency | int,
        round_to=None,
    ):
        """round_to: None (float32, the reference), or a function that
        rounds a float32 array to a lower precision after each stage."""
        self.config = Lc3Config.new(sampling_frequency, frame_duration)
        self.channels = [_Channel(self.config, round_to) for _ in range(num_channels)]

    def encode_frame(self, channel_index: int, samples_in: np.ndarray, nbytes: int) -> bytes:
        samples_in = np.asarray(samples_in, dtype=np.int16)
        return self.channels[channel_index].encode(samples_in, nbytes)
