"""The host parser: raw frame bytes -> the 19 ParsedFrames fields with the
repo's C++ bitstream codec (port of lc3jax/coding/native.py:parse_frames_native).

`lc3_parse_frames` lives in the same library as the packer
(`coding/host_pack.py` builds `native/lc3_bitstream.cc` and declares both
signatures); there is no Python parser: a failed build raises.

A bad frame sets `bad_frame` and zeroes every other output of its row (the
C++ contract, so that a reused buffer never shows an earlier batch's
value). The port's `device_parse` keeps, on a bad frame, the side fields it
read before the error; the decoder's PLC reads neither.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..config import FrameDuration, Lc3Config
from ..dsp.decoder import ParsedFrames
from . import host_pack

RING = 4  # buffer sets per batch size: a result survives the next RING - 1 parses

# (field, dtype, row shape given ne) in the order of lc3_parse_frames' outputs
FIELDS = (
    ("x_int", np.int32, "ne"), ("lsb_mode", np.uint8, ()), ("gg_ind", np.int32, ()),
    ("rc_order", np.int32, (2,)), ("rc_i", np.int32, (16,)), ("bandwidth", np.int32, ()),
    ("noise_factor", np.int32, ()), ("nf_seed", np.int32, ()), ("zero_frame", np.uint8, ()),
    ("residual_bits", np.uint8, "ne"), ("n_residual", np.int32, ()),
    ("sns_y", np.int32, (16,)), ("sns_shape", np.int32, ()), ("sns_gind", np.int32, ()),
    ("sns_ind_lf", np.int32, ()), ("sns_ind_hf", np.int32, ()),
    ("ltpf_active", np.uint8, ()), ("pitch_index", np.int32, ()), ("bad_frame", np.uint8, ()),
)
_TORCH = {np.int32: torch.int32, np.uint8: torch.uint8}


class _Slot:
    """One buffer set: host tensors (pinned for a CUDA device) and numpy
    views of them for the C++, with the event of their last copy out."""

    def __init__(self, S: int, ne: int, pin: bool):
        self.tensors = [torch.zeros((S, *((ne,) if shape == "ne" else shape)),
                                    dtype=_TORCH[dt], pin_memory=pin)
                        for _, dt, shape in FIELDS]
        self.arrays = [t.numpy() for t in self.tensors]
        self.copied = None  # torch.cuda.Event, recorded after the last upload


class HostParser:
    """The C++ parser for one config, with a ring of RING output buffer sets
    per batch size. For a CUDA device the sets are pinned: `upload` copies
    one without a sync and records an event that the parser waits on before
    it writes that set again, so a prefetch thread can parse batch k + 1
    while batch k is still being copied. Not for two threads at once: each
    parser's ring is its own."""

    def __init__(self, cfg: Lc3Config, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._lib = host_pack.load()  # builds here, not on a prefetch thread
        self._rings: dict = {}  # S -> [slots, next index]
        self._last: _Slot | None = None

    def _slot(self, S: int) -> _Slot:
        ring = self._rings.get(S)
        if ring is None:
            pin = self.device.type == "cuda"
            ring = self._rings[S] = [[_Slot(S, self.cfg.ne, pin) for _ in range(RING)], 0]
        slot = ring[0][ring[1]]
        ring[1] = (ring[1] + 1) % RING
        if slot.copied is not None:
            slot.copied.synchronize()  # its copy to the device has ended
        return slot

    def parse(self, payloads: np.ndarray) -> dict:
        """payloads uint8 [S, nbytes] -> {field: numpy array [S, ...]} with
        ParsedFrames' names and dtypes (bool or int32). The arrays are views
        of the ring: valid until RING - 1 more parses of this batch size."""
        cfg = self.cfg
        payloads = np.ascontiguousarray(payloads, np.uint8)
        if payloads.ndim != 2:
            raise ValueError(f"expected payloads [S, nbytes], got shape {payloads.shape}")
        S, nbytes = payloads.shape
        slot = self._last = self._slot(S)
        self._lib.lc3_parse_frames(
            payloads, S, nbytes, cfg.fs_ind, cfg.ne,
            1 if cfg.n_ms == FrameDuration.MS7P5 else 0, host_pack.N_THREADS, *slot.arrays)
        # the C++ writes 0 or 1 into each uint8 flag: a bool view is exact
        return {name: b.view(bool) if dt is np.uint8 else b
                for (name, dt, _), b in zip(FIELDS, slot.arrays)}

    @property
    def last(self) -> _Slot | None:
        """The buffer set of the latest parse: hand it to `upload` from
        another thread (decode_stream's prefetch thread parses, the decoding
        thread uploads)."""
        return self._last

    def upload(self, slot: _Slot | None = None, into: ParsedFrames | None = None) -> ParsedFrames:
        """A parse's fields (the latest one's where slot is None) as a
        ParsedFrames on the parser's device. On a card, copied from the
        pinned set with non_blocking=True (ordered before whatever the
        current stream runs next) into `into`, a compiled step's static
        field buffers (`CompiledStep.buffers()`: the step then copies
        nothing more), or into new tensors; on the CPU copied into `into` or
        cloned."""
        slot = self._last if slot is None else slot
        if into is None:
            out = [t.to(self.device, non_blocking=True) if self.device.type == "cuda"
                   else t.clone() for t in slot.tensors]
            into = ParsedFrames(**{name: t.view(torch.bool) if dt is np.uint8 else t
                                   for (name, dt, _), t in zip(FIELDS, out)})
        else:
            for (name, dt, _), t in zip(FIELDS, slot.tensors):
                dst = getattr(into, name)
                (dst.view(torch.uint8) if dt is np.uint8 else dst).copy_(t, non_blocking=True)
        if self.device.type == "cuda":
            if slot.copied is None:
                slot.copied = torch.cuda.Event()
            _build.record_on_stream(slot.copied, self.device)
        return into
