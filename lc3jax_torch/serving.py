"""Serving entry points: batched decode of raw frame bytes and batched
encode of PCM (ports of lc3jax/serving.py: BatchDecoder in its device-parse
and host-parse modes with decode_stream, BatchEncoder in its host-pack and
device-pack modes).

Both run on the card unless the caller passes device="cpu"; where no card
is present, the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .coding import host_pack
from .coding.device import decode_bytes_step, decode_bytes_step_stats, encode_bytes_step
from .coding.host_parse import HostParser
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
        self.state: DecoderState = decoder_init(cfg, n_streams, self.device)
        self._parser = None if device_parse else HostParser(cfg, self.device)
        self.metrics = CodecMetrics()
        self._frame_seconds = cfg.nf / cfg.fs

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
        self.state, pcm, n_bad = decode_bytes_step_stats(
            self.cfg, payloads.shape[1], self.state, payloads
        )
        # the concealed-frame count keeps plc_rate observable on the fused path
        self.metrics.record_decode(self.n_streams, self._frame_seconds, n_bad=int(n_bad))
        return pcm

    def _to_device(self, payloads: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(np.ascontiguousarray(payloads, np.uint8))
        if self.device.type != "cuda":
            return x
        # a pinned copy sent without a sync: PyTorch's pinned-memory cache
        # records an event for the copy and reuses the block only after it
        return x.pin_memory().to(self.device, non_blocking=True)

    def _host_parse(self, payloads: np.ndarray):
        """The C++ parse of one batch and its fields copied to the device:
        (ParsedFrames, n_bad, nbytes). The copy does not sync; the parser
        waits on its event before it writes that buffer set again."""
        self._check(payloads)
        n_bad = int(self._parser.parse(payloads)["bad_frame"].sum())
        return self._parser.upload(), n_bad, payloads.shape[1]

    def _decode_untracked(self, payloads: np.ndarray) -> torch.Tensor:
        """The fused step without the concealed-frame count, so without a
        sync: the PCM stays on the device."""
        self._check(payloads)
        x = self._to_device(payloads)
        self.state, pcm = decode_bytes_step(self.cfg, x.shape[1], self.state, x)
        self.metrics.record_decode(self.n_streams, self._frame_seconds)
        return pcm

    def _decode_parsed(self, frames, n_bad: int, nbytes: int) -> torch.Tensor:
        self.state, pcm = decode_step(self.cfg, nbytes * 8, self.state, frames)
        self.metrics.record_decode(self.n_streams, self._frame_seconds, n_bad=n_bad)
        return pcm

    def decode(self, payloads: np.ndarray) -> np.ndarray:
        """payloads uint8 [S, nbytes] (host) -> int16 PCM [S, nf] (host);
        nbytes may differ per call (variable bitrate mid-stream, state
        preserved)."""
        if self.device_parse:
            return self.decode_tensor(self._to_device(payloads)).cpu().numpy()
        return self._decode_parsed(*self._host_parse(payloads)).cpu().numpy()

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
            outs = []
            for batch in payload_batches:
                pcm = self._decode_parsed(*self._host_parse(batch))
                outs.append(pcm.cpu().numpy() if fetch else pcm)
        if not fetch and outs and outs[-1].is_cuda:
            torch.cuda.synchronize(outs[-1].device)  # the last batch is computed
        return outs

    def _decode_stream_pipelined(self, payload_batches, fetch: bool) -> list:
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            # any failure (the source, a bad shape, the copy) is forwarded to
            # the consumer; the sentinel is put unconditionally so that the
            # consumer never blocks for ever on q.get()
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
                pcm = self._decode_parsed(*item)
                outs.append(pcm.cpu().numpy() if fetch else pcm)
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
                self.state, pcm = decode_bytes_frames(self.cfg, x.shape[2], self.state, x)
                self.metrics.record_decode(self.n_streams * T, self._frame_seconds)
                outs.extend(pcm.cpu().numpy() if fetch else pcm.unbind(0))
                return
            for b in chunk:  # a trailing partial chunk: batch by batch
                pcm = self._decode_untracked(b)
                outs.append(pcm.cpu().numpy() if fetch else pcm)

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
