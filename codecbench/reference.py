"""The comparison that decides `correct`: the benchmark's plain reference
(`codecbench/ref`, numpy, scalar per frame) run over whole streams.

A stream's output at batch b depends on every frame before it: the
encoder's bit-budget offset (`quant.nbits_offset_old`) integrates the
error of every frame and never forgets, and the decoder's PLC seed moves
on every concealed frame. So the reference runs each checked stream from
its first frame, cold, as the program did, over the same inputs: the
stream plays frame (offset + b) mod F of its clip at batch b.

It skips work only where that is exact. The inputs repeat every F
batches, so where the reference's whole state before batch b equals its
state before batch b - F (a digest of every attribute of the coder's
channel), every later output repeats too, and the rest is copied: a
decoder that conceals no frame repeats after F + 3 frames; an encoder
does only where its bit-budget offset comes back to the same float, on
some streams. It looks every 8 batches (a digest costs a fifth of an
encoded frame), so it finds a repeat up to 7 batches late. A decoder
whose clip holds concealed frames never repeats whole, since its PLC seed
moves on each; but the seed is read only by a concealed frame. So where
its state but the seed repeats, the outputs up to the next concealed
frame are copied, and that frame is decoded from the state saved before
it one period earlier with the seed of now.
"""

from __future__ import annotations

import copy
import enum
import hashlib
import os

import numpy as np

from .ref.bitstream import BitstreamError, BufferReader
from .ref.arithmetic import ArithmeticDecodeError, decode as arith_decode
from .ref.config import FrameDuration, Lc3Config
from .ref.decoder import Lc3Decoder
from .ref.encoder import Lc3Encoder
from .ref.side_info import SideInfoError, read_side_info

DURATIONS = {10: FrameDuration.MS10, 7.5: FrameDuration.MS7P5}
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")  # one thread a worker
LOOK_EVERY = 8  # batches between two looks at the reference's state
SEED = frozenset({"plc_seed"})  # the decoder's PLC seed, read only by a concealed frame


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (to nearest, ties to even), as float32:
    the control's precision, the nearest below the configuration's float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def lc3_config(cfg: dict) -> Lc3Config:
    return Lc3Config.new(cfg["fs"], DURATIONS[cfg["frame_ms"]])


def digest(obj, skip: frozenset = frozenset()) -> bytes:
    """A 128-bit digest of everything an object holds: arrays by dtype,
    shape and bytes, numbers and flags by value, objects by their
    attributes (but those named in `skip`), recursively. Two coders with
    one digest hold one state."""
    h = hashlib.blake2b(digest_size=16)
    seen: set = set()

    def walk(o):
        if isinstance(o, np.ndarray):
            h.update(f"{o.dtype}{o.shape}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, np.generic):
            h.update(str(o.dtype).encode())
            h.update(o.tobytes())
        elif o is None or isinstance(o, (bool, int, float, str, bytes, bytearray, enum.Enum)):
            h.update(repr(o).encode())
        elif isinstance(o, (list, tuple)):
            h.update(b"[%d" % len(o))
            for v in o:
                walk(v)
        elif isinstance(o, dict):
            h.update(b"{%d" % len(o))
            for k in sorted(o):
                h.update(repr(k).encode())
                walk(o[k])
        elif callable(o) and not hasattr(o, "__dict__"):
            h.update(getattr(o, "__qualname__", repr(type(o))).encode())
        elif id(o) not in seen:
            seen.add(id(o))
            if hasattr(o, "__dict__"):
                for k in sorted(vars(o)):
                    if k not in skip:
                        h.update(k.encode())
                        walk(vars(o)[k])
            elif hasattr(o, "__slots__"):
                for k in o.__slots__:
                    walk(getattr(o, k))
            else:
                raise TypeError(f"digest: cannot read a {type(o).__name__}")

    walk(obj)
    return h.digest()


def conceals(cfg: Lc3Config, frame: bytes) -> bool:
    """Whether the reference decoder conceals this frame: its side
    information or spectrum does not parse (a frame's own property)."""
    try:
        reader = BufferReader()
        side = read_side_info(frame, reader, cfg.fs_ind, cfg.ne)
        arith_decode(frame, reader, cfg.fs_ind, cfg.ne, side,
                     cfg.n_ms == FrameDuration.MS7P5, [0] * cfg.ne)
    except (SideInfoError, ArithmeticDecodeError, BitstreamError):
        return True
    return False


def run_stream(job: dict) -> tuple[np.ndarray, int]:
    """The reference's outputs of one stream over batches 0..n-1: int16
    [n, nf] PCM (decode) or uint8 [n, nbytes] frames (encode), and the
    frames it decoded or encoded (the rest repeat, see the module's
    docstring).

    job: direction, cfg (the configuration's dict), clip ([F, nbytes] frames
    or [F, nf] PCM), offset, n, control (the reference in bfloat16, the
    control of `correct`)."""
    cfg, clip, off, n = job["cfg"], job["clip"], int(job["offset"]), int(job["n"])
    F = clip.shape[0]
    dur = DURATIONS[cfg["frame_ms"]]
    round_to = bf16 if job["control"] else None
    decode = job["direction"] == "decode"
    if decode:
        coder = Lc3Decoder(1, dur, cfg["fs"], round_to=round_to)
        out = np.empty((n, lc3_config(cfg).nf), np.int16)
        step = lambda x: coder.decode_frame(16, 0, x.tobytes())
    else:
        coder = Lc3Encoder(1, dur, cfg["fs"], round_to=round_to)
        out = np.empty((n, cfg["nbytes"]), np.uint8)
        step = lambda x: np.frombuffer(coder.encode_frame(0, x, cfg["nbytes"]), np.uint8)
    K = LOOK_EVERY if F % LOOK_EVERY == 0 else 1  # batches between two digests
    whole, but_seed = {}, {}  # digests of the state before batch b, every K batches
    concealed = None  # the clip's concealed frames, looked up once needed
    saved: dict = {}  # batch -> the decoder's state before it, at concealed frames
    computed, b = 0, 0
    while b < n:
        ch = coder.channels[0]
        if b % K == 0:
            whole[b] = digest(ch)
            but_seed[b] = digest(ch, SEED) if decode else None
        if b >= F and b % K == 0 and whole[b] == whole[b - F]:
            start = b - F  # the state repeats from here: so do the outputs
            out[b:] = out[start + (np.arange(b, n) - start) % F]
            return out, computed
        if decode and b >= F and b % K == 0 and but_seed[b] == but_seed[b - F]:
            if concealed is None:
                concealed = {f for f in range(F) if conceals(lc3_config(cfg), clip[f].tobytes())}
            c = b  # the next concealed frame
            while c < n and (off + c) % F not in concealed:
                c += 1
            if c > b and (c == n or c - F in saved):
                out[b:c] = out[b - F:c - F]
                for m in range(b + K, c + 1, K):  # the state but the seed repeats
                    whole[m], but_seed[m] = None, but_seed[m - F]
                if c == n:
                    return out, computed
                seed = ch.plc.plc_seed
                coder.channels[0] = ch = copy.deepcopy(saved[c - F])
                ch.plc.plc_seed = seed
                b = c
        if concealed is not None and (off + b) % F in concealed:
            saved = {k: v for k, v in saved.items() if k >= b - F}
            saved[b] = copy.deepcopy(ch)
        out[b] = step(clip[(off + b) % F])
        computed += 1
        b += 1
    return out, computed


def run_streams(jobs: list) -> list:
    """run_stream over jobs, each in a worker process of its own (`python -m
    codecbench.reference`, one thread, fed and read through pipes), at most
    the host's cores less one at a time; every worker has ended when this
    returns."""
    import pickle
    import subprocess
    import sys

    from .spec import ROOT

    workers = max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
    env = dict(os.environ, **{k: "1" for k in THREAD_VARS})
    results: list = []
    for at in range(0, len(jobs), workers):
        procs = [subprocess.Popen([sys.executable, "-m", "codecbench.reference"], cwd=ROOT, env=env,
                                  stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE) for _ in jobs[at:at + workers]]
        try:
            for p, job in zip(procs, jobs[at:at + workers]):
                p.stdin.write(pickle.dumps(job))  # a pickle ends itself: no EOF needed
                p.stdin.flush()
            for p in procs:
                out, err = p.communicate()
                if p.returncode != 0:
                    raise RuntimeError(f"a reference worker failed:\n{err.decode()[-3000:]}")
                results.append(pickle.loads(out))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    return results


if __name__ == "__main__":  # a worker of run_streams: one job in, its result out
    import pickle
    import sys

    pickle.dump(run_stream(pickle.load(sys.stdin.buffer)), sys.stdout.buffer)
