"""Serving entry points: batched decode of raw frame bytes and batched
encode of PCM (ports of lc3jax/serving.py: BatchDecoder in its device-parse
and host-parse modes with decode_stream, BatchEncoder in its host-pack and
device-pack modes).

Both run on the card unless the caller passes device="cpu"; where no card
is present, the default raises instead of carrying on on the CPU.

Every step runs compiled (`compiled.StepCache`, lc3jax's `_get_step` and
`_get_chunk_step`): one CUDA graph per (kind, nbytes[, T]) for the coder's
S, captured at its first call and replayed after that, all of one coder's
graphs on one static state, so the state carries across a change of
nbytes. `state` is that static state: the next call overwrites it, and
assigning a state copies it in. A result that stays on the card is a
tensor of its own (the graph's output cloned once); one fetched to the host
is read straight from the graph's output.

`metrics` (metrics.CodecMetrics) counts each call and each host read of a
device value (`host_syncs`), and records spans: `decode` (device parse) and
`encode` open a root span, `serve.decode` or `serve.encode`, with children
`serve.upload` (the host array to the card), the compiled step's
`step.copy_in` and `step.replay`, `serve.fetch` (the wait for the card and
the copy of the PCM or the frames to the host) and, decoding,
`serve.plc_count` (the concealed-frame count read).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .coding import host_pack
from .coding.device import decode_bytes_step, decode_bytes_step_stats, encode_bytes_step
from .coding.host_parse import HostParser
from .compiled import StepCache
from .config import Lc3Config
from .convert import encoder_fields_to_numpy
from .devices import resolve_device
from .dsp.decoder import DecoderState, decode_step, decoder_init
from .dsp.encoder import EncoderState, encode_step, encoder_init
from .dsp.streaming import decode_bytes_frames
from .metrics import CodecMetrics


class BatchDecoder:
    """Decodes batches of [n_streams] frames per call.

    payloads: uint8 [S, nbytes] (one frame per stream). Returns int16 PCM
    [S, nf]. Corrupt frames are concealed (PLC) per stream.

    device_parse=True (the default here): raw bytes to PCM on the device,
    the parse kernel fused with the DSP, no host work per batch.
    device_parse=False: the C++ parser on the host (coding.host_parse), the
    fields copied to the device, then the DSP step. lc3jax's BatchDecoder
    defaults to the host parse (device_parse=False).

    Every copy to a card is from pinned memory with non_blocking=True, so
    no batch waits on the host for the decode queued before it; only a PCM
    fetch (or, device-parse, the concealed-frame count) syncs."""

    def __init__(self, cfg: Lc3Config, n_streams: int, nbytes: int, device="cuda",
                 device_parse: bool = True):
        self.cfg = cfg
        self.n_streams = n_streams
        self.nbytes = nbytes
        self.device_parse = device_parse
        self.device = resolve_device(device)
        self.metrics = CodecMetrics()
        self._steps = StepCache(self.device, decoder_init(cfg, n_streams, self.device),
                                self.metrics)
        self._parser = None if device_parse else HostParser(cfg, self.device)
        self._frame_seconds = cfg.nf / cfg.fs

    @property
    def state(self) -> DecoderState:
        """The decoder's live state, which every compiled step of this
        decoder reads and updates in place: the next decode overwrites it
        (clone it to keep a snapshot). Assigning a state of the same shapes
        (a checkpoint's, on any device) copies it in."""
        return self._steps.state

    @state.setter
    def state(self, value: DecoderState) -> None:
        self._steps.state = value

    def _step(self, kind: str, nbytes: int, T: int = 0):
        """The compiled step of one kind for nbytes (and T frames): "stats"
        the fused decode with the concealed-frame count, "fused" without it,
        "parsed" decode_step on host-parsed fields, "chunk" the T-frame
        fused loop."""
        cfg = self.cfg
        fn = {"stats": lambda st, x: decode_bytes_step_stats(cfg, nbytes, st, x),
              "fused": lambda st, x: decode_bytes_step(cfg, nbytes, st, x),
              "parsed": lambda st, fr: decode_step(cfg, nbytes * 8, st, fr),
              "chunk": lambda st, x: decode_bytes_frames(cfg, nbytes, st, x)}[kind]
        return self._steps.step((kind, nbytes, T), fn)

    @property
    def steps(self) -> dict:
        """(kind, nbytes, T) -> the compiled step, for each one made so far."""
        return self._steps.steps

    def _check(self, payloads) -> None:
        if payloads.ndim != 2 or payloads.shape[0] != self.n_streams:
            raise ValueError(f"expected payloads [{self.n_streams}, nbytes], "
                             f"got {tuple(payloads.shape)}")

    def decode_tensor(self, payloads: torch.Tensor) -> torch.Tensor:
        """uint8 [S, nbytes] tensor on the decoder's device -> int16 [S, nf]
        tensor on the same device (device_parse mode). nbytes may differ per
        call (variable bitrate mid-stream, state preserved)."""
        if not self.device_parse:
            raise ValueError("decode_tensor needs BatchDecoder(..., device_parse=True)")
        self._check(payloads)
        _, pcm, n_bad = self._step("stats", payloads.shape[1])(self.state, payloads)
        # the concealed-frame count keeps plc_rate observable on the fused path
        self.metrics.host_syncs += 1
        self.metrics.record_decode(self.n_streams, self._frame_seconds, n_bad=int(n_bad))
        return pcm

    def _to_device(self, payloads: np.ndarray) -> torch.Tensor:
        payloads = np.ascontiguousarray(payloads, np.uint8)
        if not payloads.flags.writeable:  # np.frombuffer of bytes: torch warns on it
            payloads = payloads.copy()
        x = torch.as_tensor(payloads)
        if self.device.type != "cuda":
            return x
        # a pinned copy sent without a sync: PyTorch's pinned-memory cache
        # records an event for the copy and reuses the block only after it
        return x.pin_memory().to(self.device, non_blocking=True)

    def _host_parse(self, payloads: np.ndarray):
        """The C++ parse of one batch into the parser's ring: (its buffer
        set, n_bad, nbytes). The parser waits on a set's upload event before
        it writes that set again."""
        self._check(payloads)
        n_bad = int(self._parser.parse(payloads)["bad_frame"].sum())
        return self._parser.last, n_bad, payloads.shape[1]

    def _decode_parsed(self, slot, n_bad: int, nbytes: int, fetch: bool = True):
        """A parsed batch uploaded straight into the host-parse step's
        static field buffers (no further copy), then decoded: numpy PCM
        (fetch) or a tensor of its own."""
        step = self._step("parsed", nbytes)
        bufs = step.buffers()
        frames = self._parser.upload(slot, into=bufs[0] if bufs else None)
        _, pcm = (step.run if fetch else step)(self.state, frames)
        self.metrics.host_syncs += fetch
        self.metrics.record_decode(self.n_streams, self._frame_seconds, n_bad=n_bad)
        return pcm.cpu().numpy() if fetch else pcm

    def _decode_untracked(self, payloads: np.ndarray, fetch: bool = False):
        """The fused step without the concealed-frame count, so without a
        sync unless the PCM is fetched."""
        self._check(payloads)
        x = self._to_device(payloads)
        step = self._step("fused", x.shape[1])
        _, pcm = (step.run if fetch else step)(self.state, x)
        self.metrics.host_syncs += fetch
        self.metrics.record_decode(self.n_streams, self._frame_seconds)
        return pcm.cpu().numpy() if fetch else pcm

    def decode(self, payloads: np.ndarray) -> np.ndarray:
        """payloads uint8 [S, nbytes] (host) -> int16 PCM [S, nf] (host);
        nbytes may differ per call (variable bitrate mid-stream, state
        preserved)."""
        if not self.device_parse:
            return self._decode_parsed(*self._host_parse(payloads))
        m = self.metrics
        t_call = m.begin()
        try:
            self._check(payloads)
            t = time.time_ns()
            x = self._to_device(payloads)
            m.span("serve.upload", t)
            _, pcm, n_bad = self._step("stats", payloads.shape[1]).run(self.state, x)
            t = time.time_ns()
            out = pcm.cpu().numpy()
            m.span("serve.fetch", t)
            t = time.time_ns()
            n_bad = int(n_bad)
            m.span("serve.plc_count", t)
            m.host_syncs += 2
            m.record_decode(self.n_streams, self._frame_seconds, n_bad=n_bad)
            return out
        finally:
            m.end("serve.decode", t_call)

    def decode_stream(self, payload_batches, fetch: bool = True, pipeline: bool = False,
                      chunk_frames: int = 0) -> list:
        """Decode an iterable of uint8 [S, nbytes] batches; returns the PCM of
        each, int16 [S, nf]: numpy arrays (fetch=True) or tensors on the
        device (fetch=False; the call returns once the last is computed).

        Host-parse mode: pipeline=True parses (and copies) batch k + 1 on a
        prefetch thread while batch k decodes; an error on that thread is
        raised here once it has ended.

        Device-parse mode: each batch goes to the fused step; pipeline is
        ignored (there is no host stage to overlap). fetch=True counts the
        concealed frames on the device and fetches the count with the PCM;
        fetch=False syncs only after the last batch, so plc_frames is not
        tracked. chunk_frames=T > 1 stacks T consecutive batches into one
        [T, S, nbytes] copy through dsp.streaming.decode_bytes_frames, with
        one PCM fetch per chunk; a change of nbytes closes a chunk and a
        trailing partial chunk is decoded batch by batch (plc_frames is not
        tracked either)."""
        if self.device_parse and chunk_frames > 1:
            outs = self._decode_stream_chunked(payload_batches, fetch, chunk_frames)
        elif self.device_parse:
            outs = [self.decode(b) if fetch else self._decode_untracked(b)
                    for b in payload_batches]
        elif pipeline:
            outs = self._decode_stream_pipelined(payload_batches, fetch)
        else:
            outs = [self._decode_parsed(*self._host_parse(b), fetch) for b in payload_batches]
        if not fetch and outs and outs[-1].is_cuda:
            torch.cuda.synchronize(outs[-1].device)  # the last batch is computed
        return outs

    def _decode_stream_pipelined(self, payload_batches, fetch: bool) -> list:
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            # the C++ parse only: the upload and the decode run on the
            # consumer. The queue's bound keeps at most RING parsed sets not
            # yet uploaded (two queued, one the consumer holds, one being
            # parsed), so a set is parsed again only after its upload's
            # event was recorded. Any failure (the source, a bad shape) is
            # forwarded to the consumer; the sentinel is put unconditionally
            # so that the consumer never blocks for ever on q.get()
            try:
                for batch in payload_batches:
                    if stop.is_set():
                        break
                    q.put(self._host_parse(batch))
            except BaseException as e:  # noqa: BLE001 - raised in the caller
                q.put(e)
            finally:
                q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        outs, err, item = [], None, ()
        try:
            while (item := q.get()) is not None:
                if isinstance(item, BaseException):
                    err = item
                    continue  # drain to the sentinel, then join and raise
                outs.append(self._decode_parsed(*item, fetch))
        finally:
            # if the decode failed, stop the producer and drain its queue so
            # that it reaches its sentinel and ends
            stop.set()
            while item is not None:
                item = q.get()
            th.join()
        if err is not None:
            raise err
        return outs

    def _decode_stream_chunked(self, payload_batches, fetch: bool, T: int) -> list:
        outs: list = []

        def flush(chunk):
            if len(chunk) == T:
                x = self._to_device(np.stack(chunk))
                step = self._step("chunk", x.shape[2], T)
                _, pcm = (step.run if fetch else step)(self.state, x)
                self.metrics.host_syncs += fetch
                self.metrics.record_decode(self.n_streams * T, self._frame_seconds)
                outs.extend(pcm.cpu().numpy() if fetch else pcm.unbind(0))
                return
            # a chunk closed early: batch by batch
            outs.extend(self._decode_untracked(b, fetch) for b in chunk)

        buf: list = []
        for batch in payload_batches:
            self._check(batch)
            if buf and batch.shape[1] != buf[0].shape[1]:
                flush(buf)  # nbytes changed mid-stream: close the chunk
                buf = []
            buf.append(batch)
            if len(buf) == T:
                flush(buf)
                buf = []
        if buf:
            flush(buf)
        return outs


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
        self.metrics = CodecMetrics()
        self._steps = StepCache(self.device, encoder_init(cfg, n_streams, self.device),
                                self.metrics)
        self._frame_seconds = cfg.nf / cfg.fs

    @property
    def state(self) -> EncoderState:
        """The encoder's live state, updated in place by every compiled step
        (see BatchDecoder.state)."""
        return self._steps.state

    @state.setter
    def state(self, value: EncoderState) -> None:
        self._steps.state = value

    def _step(self, kind: str, nbytes: int):
        """The compiled step of one kind for nbytes: "fields" the DSP step
        (encode_step), "bytes" the fused PCM-to-bytes step."""
        cfg = self.cfg
        fn = {"fields": lambda st, x: encode_step(cfg, nbytes, st, x),
              "bytes": lambda st, x: encode_bytes_step(cfg, nbytes, st, x)}[kind]
        return self._steps.step((kind, nbytes), fn)

    @property
    def steps(self) -> dict:
        """(kind, nbytes) -> the compiled step, for each one made so far."""
        return self._steps.steps

    def _check(self, pcm) -> None:
        if tuple(pcm.shape) != (self.n_streams, self.cfg.nf):
            raise ValueError(f"expected PCM [{self.n_streams}, {self.cfg.nf}], "
                             f"got {tuple(pcm.shape)}")

    def encode_fields_tensor(self, pcm: torch.Tensor, nbytes: int | None = None) -> dict:
        """int16 [S, nf] tensor on the encoder's device -> the bitstream
        fields, tensors on the same device (the names of encode_step)."""
        self._check(pcm)
        nbytes = self.nbytes if nbytes is None else nbytes
        _, fields = self._step("fields", nbytes)(self.state, pcm)
        return fields

    def encode_tensor(self, pcm: torch.Tensor, nbytes: int | None = None) -> torch.Tensor:
        """int16 [S, nf] tensor on the encoder's device -> uint8 [S, nbytes]
        frames on the same device (device_pack mode; the twin of
        BatchDecoder.decode_tensor)."""
        if not self.device_pack:
            raise ValueError("encode_tensor needs BatchEncoder(..., device_pack=True)")
        self._check(pcm)
        nbytes = self.nbytes if nbytes is None else nbytes
        _, payloads = self._step("bytes", nbytes)(self.state, pcm)
        self.metrics.record_encode(self.n_streams, self._frame_seconds)
        return payloads

    def encode(self, pcm: np.ndarray, nbytes: int | None = None) -> np.ndarray:
        """pcm int16 [S, nf] (host) -> uint8 [S, nbytes] (host). nbytes may
        change per call (variable bitrate mid-stream, state preserved: the
        encoder state does not depend on it)."""
        nbytes = self.nbytes if nbytes is None else nbytes
        m = self.metrics
        t_call = m.begin()
        try:
            t = time.time_ns()
            x = torch.as_tensor(np.ascontiguousarray(pcm, np.int16)).to(self.device)
            m.span("serve.upload", t)
            self._check(x)
            # the graph's outputs fetched to the host at once, not cloned
            _, out = self._step("bytes" if self.device_pack else "fields", nbytes).run(
                self.state, x)
            m.record_encode(self.n_streams, self._frame_seconds)
            if not self.device_pack:
                fields = encoder_fields_to_numpy(out)
                m.host_syncs += sum(isinstance(v, torch.Tensor) for v in out.values())
                return host_pack.pack_frames(self.cfg, fields, nbytes)
            t = time.time_ns()
            frames = out.cpu().numpy()
            m.span("serve.fetch", t)
            m.host_syncs += 1
            return frames
        finally:
            m.end("serve.encode", t_call)
