#!/usr/bin/env python3
"""Where the time of one lc3jax_torch step goes on a CUDA card.

    python3 tools/torch_profile.py [--streams 2048] [--steps 10] [--tree DIR]
    python3 tools/torch_profile.py --stages [--tree DIR]

For the fused decode step (`BatchDecoder.decode_tensor`), the encode DSP
step (`BatchEncoder.encode_fields_tensor`) and the fused encode step
(`BatchEncoder(device_pack=True).encode_tensor`) at 48 kHz / 10 ms /
150 B, on the bench content of tests/goldens/torch_bench_content.npz tiled
over the streams, after warm-up:

- host wall per step: `steps` steps issued back to back, one synchronise;
- device busy per step: the union of the card's activity intervals under
  `torch.profiler` over `steps` steps, and the busy share it gives of the
  wall step (the idle share is the rest);
- device launches per step, and the eight names that take the most device
  time;
- for the encoder, each stage of the eager `encode_step` synchronised on
  its own: device busy per step (the card's intervals inside the stage's
  range: what a replayed graph of the step spends there, less the gaps
  between its nodes); and the host side after the DSP step: the copy of
  the fields to the host and the C++ packer, each a median of `steps`
  calls.

The three serving steps run as replayed CUDA graphs (`compiled.py`), each
line with its graph's nodes; the same lines follow for the eager step
functions (`decode_eager`, `encode_dsp_eager`, `encode_fused_eager`, from
a fixed state).

--stages prints only the encode stages' device split (`encode_stage_device`)
of the eager encode step at the benchmark cells' settings, 48 kHz / 10 ms /
120 B, 16 kHz / 10 ms / 40 B and 48 kHz / 7.5 ms / 75 B, on the bench
content cut into each setting's frames.

--tree DIR profiles the lc3jax_torch of another checkout (an older commit
unpacked with `git archive` into a directory `.gitignore` lists) with this
script's measurement, so that two versions compare in one call.

Prints one line per step kind and ends with one JSON object. Needs a card;
without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
NBYTES = 150


def wall_ms(fn, steps: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def median_ms(fn, steps: int) -> float:
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_profile(fn, steps: int) -> dict:
    """Busy ms per step (the union of the card's intervals over `steps`
    steps issued back to back, lc3jax_torch.profiling), launches per step
    and the top names by device time, from torch.profiler."""
    from lc3jax_torch import profiling

    spans = profiling.device_spans(lambda: [fn() for _ in range(steps)])
    by_name = defaultdict(float)
    for a, b, name in spans:
        by_name[name] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "busy_ms": profiling.union_ms(spans) / steps,
        "launches": len(spans) / steps,
        "top": [(name[:60], us / steps / 1e3) for name, us in top],
    }


ENCODE_STAGES = ("forward_mdct", "bandwidth_detect", "attack_detect", "sns_analysis",
                 "tns_analysis_batch", "ltpf_analysis", "spectral_quantize",
                 "residual_bits_batch", "noise_level_batch")


def encode_stage_device(fn, steps: int) -> dict:
    """Device busy ms per step of each stage of the eager encode_step: each
    stage in a `profiling.mark` range, synchronised before and after, so
    that its device work lies inside its range; per stage, the union of the
    card's intervals that start inside its ranges
    (`profiling.marked_spans`: the kernels a replayed graph of the step
    runs too, without the gaps the host leaves)."""
    import torch

    from lc3jax_torch import profiling
    from lc3jax_torch.dsp import encoder as E

    originals = {name: getattr(E, name) for name in ENCODE_STAGES}

    def marked(name, orig):
        def run(*a, **k):
            torch.cuda.synchronize()
            with profiling.mark(name):
                out = orig(*a, **k)
                torch.cuda.synchronize()
            return out
        return run

    for name, orig in originals.items():
        setattr(E, name, marked(name, orig))
    try:
        per = profiling.marked_spans(lambda: [fn() for _ in range(steps)])
    finally:
        for name, orig in originals.items():
            setattr(E, name, orig)
    spans = defaultdict(list)
    for name, s in per:
        spans[name] += s
    return {name: profiling.union_ms(spans[name]) / steps for name in ENCODE_STAGES}


def stages_only(card: str, S: int, steps: int, fs: int, dur, nbytes: int) -> None:
    """encode_stage_device of the eager encode step at fs / dur (a FrameDuration) /
    nbytes."""
    import torch

    import lc3jax_torch
    from lc3jax_torch.config import Lc3Config
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init

    cfg = Lc3Config.new(fs, dur)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    rows = bench["pcm_in"].reshape(4, -1)[:, : 2 * cfg.nf].reshape(4, 2, cfg.nf)
    dev = torch.device("cuda")
    pcm = [torch.as_tensor(rows[np.arange(S) % 4, f], device=dev) for f in range(2)]
    st = encoder_init(cfg, S, dev)
    st, _ = encode_step(cfg, nbytes, st, pcm[0])  # a state past the first frame
    fn = lambda: encode_step(cfg, nbytes, st, pcm[1])
    for _ in range(3):
        fn()
    stage_dev = encode_stage_device(fn, steps)
    tree = str(Path(lc3jax_torch.__file__).parent)
    print(f"[encode-stages-device] {card}, S={S}, {fs} Hz / {dur.value} / {nbytes} B, {tree}, "
          "device busy per step: " + "; ".join(
              f"{n} {ms:.3f} ms" for n, ms in sorted(stage_dev.items(), key=lambda kv: -kv[1]))
          + f" (sum {sum(stage_dev.values()):.3f} ms)", flush=True)
    print(json.dumps({"card": card, "streams": S, "steps": steps, "fs": fs, "frame": dur.value,
                      "nbytes": nbytes, "tree": tree, "encode_stages_device_ms": stage_dev}))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tree", type=Path, default=ROOT, help="checkout whose lc3jax_torch to profile")
    ap.add_argument("--stages", action="store_true",
                    help="only the encode stages' device split at the cells' settings")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    from lc3jax_torch.coding import host_pack
    from lc3jax_torch.coding.device import decode_bytes_step_stats, encode_bytes_step
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import encoder_fields_to_numpy
    from lc3jax_torch.dsp.decoder import decoder_init
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init
    from lc3jax_torch.serving import BatchDecoder, BatchEncoder

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    S, steps = args.streams, args.steps
    if args.stages:
        for fs, dur, nbytes in ((48000, FrameDuration.MS10, 120), (16000, FrameDuration.MS10, 40),
                                (48000, FrameDuration.MS7P5, 75)):
            stages_only(card, S, steps, fs, dur, nbytes)
        return 0
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    tile = np.arange(S) % 4
    dev = torch.device("cuda")
    pay = torch.as_tensor(bench["encoded"][tile, 0], device=dev)
    pcm = torch.as_tensor(bench["pcm_in"][tile, 0], device=dev)
    dec = BatchDecoder(cfg, S, NBYTES, device="cuda")
    enc = BatchEncoder(cfg, S, NBYTES, device="cuda")
    fenc = BatchEncoder(cfg, S, NBYTES, device="cuda", device_pack=True)
    st_d, st_e = decoder_init(cfg, S, dev), encoder_init(cfg, S, dev)
    steps_of = {"decode": lambda: dec.decode_tensor(pay),
                "encode_dsp": lambda: enc.encode_fields_tensor(pcm),
                "encode_fused": lambda: fenc.encode_tensor(pcm),
                "decode_eager": lambda: decode_bytes_step_stats(cfg, NBYTES, st_d, pay),
                "encode_dsp_eager": lambda: encode_step(cfg, NBYTES, st_e, pcm),
                "encode_fused_eager": lambda: encode_bytes_step(cfg, NBYTES, st_e, pcm)}
    import lc3jax_torch

    out = {"card": card, "streams": S, "steps": steps, "tree": str(Path(lc3jax_torch.__file__).parent)}
    coders = {"decode": dec, "encode_dsp": enc, "encode_fused": fenc}
    for name, fn in steps_of.items():
        for _ in range(3):
            fn()
        wall = wall_ms(fn, steps)
        prof = device_profile(fn, steps)
        nodes = (sum(sum(s.node_counts()) for s in coders[name].steps.values())
                 if name in coders else None)
        out[name] = dict(wall_ms=wall, busy_share=prof["busy_ms"] / wall, graph_nodes=nodes, **prof)
        print(f"[{name}] {card}, S={S}: {'' if nodes is None else f'{nodes} graph nodes, '}"
              f"wall {wall:.3f} ms/step, device busy "
              f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_ms'] / wall:.1f}%), "
              f"{prof['launches']:.0f} device launches/step; top: " + "; ".join(
                  f"{n} {ms:.4f} ms" for n, ms in prof["top"]), flush=True)
    stage_dev = encode_stage_device(steps_of["encode_dsp_eager"], steps)
    out["encode_stages_device_ms"] = stage_dev
    print(f"[encode-stages-device] {card}, S={S}, device busy per step: " + "; ".join(
        f"{n} {ms:.3f} ms" for n, ms in sorted(stage_dev.items(), key=lambda kv: -kv[1]))
        + f" (sum {sum(stage_dev.values()):.3f} ms)", flush=True)
    fields = enc.encode_fields_tensor(pcm)
    torch.cuda.synchronize()
    to_host = median_ms(lambda: encoder_fields_to_numpy(fields), steps)
    f_np = encoder_fields_to_numpy(fields)
    pack = median_ms(lambda: host_pack.pack_frames(cfg, f_np, NBYTES), steps)
    whole = median_ms(lambda: enc.encode(bench["pcm_in"][tile, 0]), steps)
    out["encode_host"] = {"fields_to_host_ms": to_host, "pack_ms": pack, "encode_ms": whole}
    print(f"[encode-host] {card}, S={S}: fields to host {to_host:.3f} ms, C++ pack "
          f"{pack:.3f} ms, whole encode {whole:.3f} ms (medians of {steps})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
