"""Frame-axis streaming: T frames of S streams in one call (port of
lc3jax/dsp/streaming.py).

JAX scans the frame axis with `lax.scan` in one compiled program; here each
function is a Python loop over the frames, one step after another, that
returns the per-frame outputs stacked on a leading [T] axis. The
`make_*` factories return it compiled (`compiled.CompiledStep`): the whole
T-frame loop captured as one CUDA graph per T, taken from the input's
shape, so that a chunk costs one replay, as JAX makes one dispatch a chunk.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..compiled import CompiledStep
from ..config import Lc3Config
from .decoder import DecoderState, ParsedFrames, decode_step
from .encoder import EncoderState, encode_step


def _stack(outs: list) -> dict:
    """Per-frame field dicts -> one dict, tensors stacked on a leading [T]
    axis; Python scalars (the same every frame) stay scalars."""
    return {k: torch.stack([o[k] for o in outs]) if isinstance(v, torch.Tensor) else v
            for k, v in outs[0].items()}


def decode_frames(cfg: Lc3Config, nbits: int, state: DecoderState, frames: ParsedFrames):
    """frames: ParsedFrames with a leading frame axis [T, S, ...].
    Returns (state, pcm int16 [T, S, nf])."""
    T = frames.x_int.shape[0]
    pcm = []
    for t in range(T):
        fr = ParsedFrames(**{f.name: getattr(frames, f.name)[t]
                             for f in dataclasses.fields(frames)})
        state, out = decode_step(cfg, nbits, state, fr)
        pcm.append(out)
    return state, torch.stack(pcm)


def encode_frames(cfg: Lc3Config, nbytes: int, state: EncoderState, pcm):
    """pcm: int16 [T, S, nf]. Returns (state, fields with a leading [T] axis)."""
    fields = []
    for t in range(pcm.shape[0]):
        state, f = encode_step(cfg, nbytes, state, pcm[t])
        fields.append(f)
    return state, _stack(fields)


def decode_bytes_frames(cfg: Lc3Config, nbytes: int, state: DecoderState, payloads):
    """Fused bulk decode: raw frame bytes [T, S, nbytes] -> (state, PCM
    int16 [T, S, nf]), the range decoder on the device."""
    from ..coding.device import decode_bytes_step

    pcm = []
    for t in range(payloads.shape[0]):
        state, out = decode_bytes_step(cfg, nbytes, state, payloads[t])
        pcm.append(out)
    return state, torch.stack(pcm)


def encode_bytes_frames(cfg: Lc3Config, nbytes: int, state: EncoderState, pcm):
    """Fused bulk encode: PCM [T, S, nf] -> (state, frame bytes uint8
    [T, S, nbytes]), the range encoder on the device."""
    from ..coding.device import encode_bytes_step

    out = []
    for t in range(pcm.shape[0]):
        state, payloads = encode_bytes_step(cfg, nbytes, state, pcm[t])
        out.append(payloads)
    return state, torch.stack(out)


def make_decode_frames(cfg: Lc3Config, nbits: int, device="cuda") -> CompiledStep:
    """decode_frames compiled: `step(state, frames [T, S, ...]) -> (state,
    pcm [T, S, nf])`, the state donated (see dsp.decoder.make_decode_step)."""
    return CompiledStep(partial(decode_frames, cfg, nbits), ("decode_frames", cfg, nbits), device)


def make_encode_frames(cfg: Lc3Config, nbytes: int, device="cuda") -> CompiledStep:
    """encode_frames compiled: `step(state, pcm [T, S, nf]) -> (state, fields)`."""
    return CompiledStep(partial(encode_frames, cfg, nbytes), ("encode_frames", cfg, nbytes),
                        device)


def make_decode_bytes_frames(cfg: Lc3Config, nbytes: int, device="cuda") -> CompiledStep:
    """decode_bytes_frames compiled: `step(state, payloads [T, S, nbytes]) ->
    (state, pcm [T, S, nf])`."""
    return CompiledStep(partial(decode_bytes_frames, cfg, nbytes),
                        ("decode_bytes_frames", cfg, nbytes), device)


def make_encode_bytes_frames(cfg: Lc3Config, nbytes: int, device="cuda") -> CompiledStep:
    """encode_bytes_frames compiled: `step(state, pcm [T, S, nf]) -> (state,
    frames uint8 [T, S, nbytes])`."""
    return CompiledStep(partial(encode_bytes_frames, cfg, nbytes),
                        ("encode_bytes_frames", cfg, nbytes), device)
