"""File-to-file CLI: encode / decode / compare / inspect (port of
lc3jax/runner/cli.py).

Raw back-to-back `.lc3` frame streams (frame size out of band), channels
interleaved per frame, as the reference's examples (encode.rs, decode.rs,
compare.rs) write them. Channels ride the stream axis of the batched codec:
`encode` runs BatchEncoder with the C++ packer on the host, `decode` runs
BatchDecoder with the C++ parser on the host (device_parse=False), and
`inspect` the port's side-info reader. The three run on the card unless
--device cpu is given. lc3jax's `--oracle` path is not here: the oracle is
the JAX package's, which this package does not import.

Usage:
  python -m lc3jax_torch.runner.cli encode in.wav out.lc3 --nbytes 150
  python -m lc3jax_torch.runner.cli decode in.lc3 out.wav --rate 48000 --channels 1 --nbytes 150
  python -m lc3jax_torch.runner.cli compare a.lc3 b.lc3
  python -m lc3jax_torch.runner.cli inspect in.lc3 --rate 48000 --nbytes 150
  python -m lc3jax_torch.runner.cli --device cpu inspect in.lc3 --nbytes 150
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import FrameDuration, Lc3Config
from .wav import read_wav, write_wav


def _duration(arg: str) -> FrameDuration:
    return FrameDuration.MS7P5 if arg in ("7.5", "7.5ms") else FrameDuration.MS10


def cmd_encode(args) -> int:
    from ..serving import BatchEncoder

    samples, rate = read_wav(args.input)
    n, channels = samples.shape
    cfg = Lc3Config.new(rate, _duration(args.duration))
    nf = cfg.nf
    nframes = n // nf
    print(f"encoding {nframes} frames x {channels} ch @ {rate} Hz -> {args.nbytes} B/frame")
    enc = BatchEncoder(cfg, channels, args.nbytes, device=args.device)
    with open(args.output, "wb") as f:
        for i in range(nframes):
            f.write(enc.encode(samples[i * nf : (i + 1) * nf].T).tobytes())  # [ch, nbytes]
    return 0


def cmd_decode(args) -> int:
    from ..serving import BatchDecoder

    with open(args.input, "rb") as f:
        data = f.read()
    cfg = Lc3Config.new(args.rate, _duration(args.duration))
    channels, nbytes = args.channels, args.nbytes
    nframes = len(data) // (nbytes * channels)
    print(f"decoding {nframes} frames x {channels} ch @ {args.rate} Hz")
    frames = np.frombuffer(data, np.uint8)[: nframes * channels * nbytes]
    dec = BatchDecoder(cfg, channels, nbytes, device=args.device, device_parse=False)
    pcm = dec.decode_stream(frames.reshape(nframes, channels, nbytes))  # [ch, nf] each
    out = np.concatenate([p.T for p in pcm]) if pcm else np.zeros((0, channels), np.int16)
    write_wav(args.output, out, cfg.fs)
    return 0


def cmd_inspect(args) -> int:
    """Print each frame's side info (the reference's read_sideinfo.rs
    example), read by the port's side-info reader on --device."""
    from ..coding.device import _TailReader, read_side_info
    from ..devices import resolve_device

    dev = resolve_device(args.device)
    cfg = Lc3Config.new(args.rate, _duration(args.duration))
    with open(args.input, "rb") as f:
        data = f.read()
    n = min(len(data) // args.nbytes, args.limit)
    if n == 0:
        return 0
    buf = np.frombuffer(data, np.uint8)[: n * args.nbytes].reshape(n, args.nbytes)
    si, bad = read_side_info(_TailReader(torch.as_tensor(buf.astype(np.int64), device=dev)),
                             cfg, n)
    v = {k: t.tolist() for k, t in si.items()}
    bad = bad.tolist()
    for i in range(n):
        if bad[i]:
            print(f"frame {i}: CORRUPT (side info)")
            continue
        print(
            f"frame {i}: bw={v['p_bw'][i]} lastnz={v['lastnz'][i]} "
            f"lsb={int(v['lsb_mode'][i])} gg={v['gg_ind'][i]} "
            f"tns={v['num_tns'][i]}x[{v['rc_flag0'][i]}, {v['rc_flag1'][i]}] "
            f"sns(shape={v['shape_j'][i]},lf={v['ind_lf'][i]},hf={v['ind_hf'][i]}) "
            f"ltpf(present={int(v['pitch_present'][i])},"
            f"active={int(v['ltpf_active'][i])},idx={v['pitch_index'][i]}) "
            f"nf={v['noise_factor'][i]}"
        )
    return 0


def cmd_compare(args) -> int:
    """Byte-diff two .lc3 streams (examples/compare.rs)."""
    with open(args.a, "rb") as f:
        a = f.read()
    with open(args.b, "rb") as f:
        b = f.read()
    if len(a) != len(b):
        print(f"length mismatch: {len(a)} vs {len(b)}")
    n = min(len(a), len(b))
    diffs = np.flatnonzero(np.frombuffer(a, np.uint8, n) != np.frombuffer(b, np.uint8, n))
    if not diffs.size:
        print(f"identical ({n} bytes)")
        return 0
    print(f"{diffs.size} differing bytes; first at {diffs[0]}")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lc3jax_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codec (default cuda; cpu runs the plain versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--nbytes", type=int, default=150)
    pe.add_argument("--duration", default="10")
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--rate", type=int, default=48000)
    pd.add_argument("--channels", type=int, default=1)
    pd.add_argument("--nbytes", type=int, default=150)
    pd.add_argument("--duration", default="10")
    pd.set_defaults(fn=cmd_decode)

    pc = sub.add_parser("compare")
    pc.add_argument("a")
    pc.add_argument("b")
    pc.set_defaults(fn=cmd_compare)

    pi = sub.add_parser("inspect")
    pi.add_argument("input")
    pi.add_argument("--rate", type=int, default=48000)
    pi.add_argument("--nbytes", type=int, default=150)
    pi.add_argument("--duration", default="10")
    pi.add_argument("--limit", type=int, default=20)
    pi.set_defaults(fn=cmd_inspect)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
