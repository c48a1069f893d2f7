"""Reference-exact LC3 decoder (host oracle).

API mirrors the reference Lc3Decoder (decoder/lc3_decoder.rs:180-244):
per-channel streaming state, `decode_frame(num_bits_per_sample, channel,
buf_in) -> int16[nf]`, corrupt frames routed to packet-loss concealment.
"""

from __future__ import annotations

import numpy as np

from .config import FrameDuration, Lc3Config, SamplingFrequency
from . import decoder_stages as stages
from .arithmetic import ArithmeticDecodeError, decode as arith_decode
from .bitstream import BitstreamError, BufferReader
from .imdct import InverseMdct
from .ltpf import LongTermPostFilter
from .side_info import LtpfInfo, SideInfoError, read_side_info

F32 = np.float32


class _Channel:
    def __init__(self, cfg: Lc3Config, round_to=None):
        self.cfg = cfg
        self.plc = stages.PacketLossConcealment(cfg.ne)
        self.imdct = InverseMdct(cfg)
        self.ltpf = LongTermPostFilter(cfg)
        self.round_to = round_to

    def decode(self, buf_in: bytes) -> np.ndarray:
        cfg = self.cfg
        nbits = len(buf_in) * 8
        x = np.zeros(cfg.ne, dtype=F32)
        try:
            reader = BufferReader()
            side = read_side_info(buf_in, reader, cfg.fs_ind, cfg.ne)
            x_int = [0] * cfg.ne
            arith = arith_decode(
                buf_in, reader, cfg.fs_ind, cfg.ne, side,
                cfg.n_ms == FrameDuration.MS7P5, x_int,
            )
            x[:] = np.array(x_int, dtype=F32)
            stages.residual_decode(side.lsb_mode, arith.residual_bits, x)
            stages.noise_filling(
                arith.is_zero_frame, arith.noise_filling_seed, side.bandwidth,
                cfg.n_ms, side.noise_factor, x_int, x,
            )
            stages.global_gain(arith.frame_num_bits, cfg.fs_ind, side.global_gain_index, x)
            self._round(x)
            stages.tns_synthesis(
                cfg.n_ms, side.bandwidth, side.num_tns_filters,
                arith.reflect_coef_order, arith.reflect_coef_ints, x,
            )
            self._round(x)
            stages.sns_decode(cfg, side.sns_vq, x)
            self._round(x)
            self.plc.save(x)
            ltpf_info = side.ltpf
        except (SideInfoError, ArithmeticDecodeError, BitstreamError):
            self.plc.load_into(x)
            ltpf_info = LtpfInfo(pitch_present=False, is_active=False, pitch_index=0)

        t = self.imdct.run(x)
        self._round(t)
        t = self.ltpf.run(ltpf_info, nbits, t)
        self._round(t)
        return stages.output_scaling(t)

    def _round(self, x: np.ndarray) -> None:
        """Rounds a stage's float32 output in place to a lower precision
        (the benchmark's control); nothing in float32."""
        if self.round_to is not None:
            x[:] = self.round_to(x)


class Lc3Decoder:
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

    def decode_frame(
        self, num_bits_per_audio_sample: int, channel_index: int, buf_in: bytes
    ) -> np.ndarray:
        if num_bits_per_audio_sample != 16:
            raise ValueError("only 16 bits per audio sample supported")
        return self.channels[channel_index].decode(bytes(buf_in))
