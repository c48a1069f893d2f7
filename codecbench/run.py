"""Runs one cell of the benchmark once, on one NVIDIA card:

    python -m codecbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (`configs/<name>.json`) under a traffic mix
(`traffic/<name>.json`), both named in `BENCHMARK.json`. The run makes its
inputs from the seed, builds the coder that the mix names (a class of
`lc3jax_torch.serving`, its options and the call made once a batch) for
the configuration's streams, warms it up (the first call captures its
CUDA graph), then calls it back to back for `--seconds`: a closed loop,
host arrays in and out. It records every call's time and the outputs of
a few streams drawn from the seed. After the window, `--trace 1` profiles
a short sub-window of the same loop; then the reference (`reference.py`)
runs those streams from their first frame and the outputs are compared
(`limits/<cell>.json`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit (also the last
lines of standard error). Without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before the imports: set-up starts here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from . import reference, spec  # noqa: E402
from . import trace as tracing  # noqa: E402
from .traffic import Traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lc3jax")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, jaxlib's,
    flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def _coder(cfg: dict, mix: dict, streams: int, device: str):
    """(the coder, the call the loop makes), as the mix's `coder` names them:
    a class of `lc3jax_torch.serving` built for the configuration's geometry
    and the streams, with the mix's keyword `options`, and its method `call`,
    made once a batch with a host array [streams, ...] in and one out."""
    from lc3jax_torch import serving
    from lc3jax_torch.config import FrameDuration, Lc3Config

    dur = {10: FrameDuration.MS10, 7.5: FrameDuration.MS7P5}[cfg["frame_ms"]]
    named = mix["coder"]
    c = getattr(serving, named["class"])(Lc3Config.new(cfg["fs"], dur), streams, cfg["nbytes"],
                                         device=device, **named["options"])
    return c, getattr(c, named["call"])


def compare(direction: str, prog: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers compared, from the checked streams' outputs [streams, n,
    ...]: decode, the widest gap of a PCM sample in LSB; encode, the frames
    that differ in any byte."""
    if direction == "decode":
        return {"pcm_max_abs_lsb": int(np.abs(prog.astype(np.int32) - ref).max())}
    return {"frames_differing": int((prog != ref).any(axis=-1).sum())}


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        streams: int | None = None, t_start: float | None = None,
        control: bool = False) -> tuple[dict, dict, list]:
    """One run of a cell: (result, {number: (value, limit)}, lines for
    standard error). `streams` overrides the configuration's (the CPU
    tests); `control` puts the reference in bfloat16 in the program's place
    for the checked streams (the control of `correct`)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("torch", time.perf_counter())]
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    if mix["loop"] != "closed":
        raise ValueError(f"mix {mix['name']}: a {mix['loop']!r} loop; the harness runs 'closed'")
    S = streams or cfg["streams"]
    on_card = device != "cpu"
    direction = mix["direction"]
    inputs = Traffic(cfg, mix, seed, S)
    marks.append(("inputs", time.perf_counter()))
    coder, call = _coder(cfg, mix, S, device)
    marks.append(("coder", time.perf_counter()))
    checked, rows = inputs.checked, []
    n = 0

    def one_batch():
        nonlocal n
        out = call(inputs.batch(n))
        rows.append(out[checked])
        n += 1

    for _ in range(mix["warmup_batches"]):  # the first captures the graph
        one_batch()
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    # the measured window: back to back, each call timed between two CUDA
    # events on the card's stream, which is idle at both edges (the call
    # fetches its output), and on the host's clock
    lat_events, lat_host = [], []
    gc.collect()
    gc.disable()
    first = n
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if on_card:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        h0 = time.perf_counter()
        out = call(inputs.batch(n))
        h1 = time.perf_counter()
        if on_card:
            e1.record()
            lat_events.append((e0, e1))
        lat_host.append(h1 - h0)
        rows.append(out[checked])
        n += 1
        if h1 >= deadline:
            break
    wall = time.perf_counter() - t0
    gc.enable()
    batches = n - first
    if on_card:
        torch.cuda.synchronize()
        lat_ms = np.array([a.elapsed_time(b) for a, b in lat_events])
    else:
        lat_ms = np.array(lat_host) * 1e3
    audio_s = batches * S * cfg["frame_ms"] / 1e3

    values = {"setup_s": setup_s,
              f"{direction}_x_realtime": audio_s / wall,
              f"{direction}_p95_ms": float(np.percentile(lat_ms, 95))}
    result = {"correct": False, "attempted": batches * S, "failed": 0}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": 1}
    phases = ", ".join(f"{k} {t - t_prev:.3f}"
                       for (k, t), t_prev in zip(marks, [t_start] + [t for _, t in marks]))
    err = [f"{cell['name']} seed {seed}: {batches} batches of {S} streams in {wall:.3f} s; "
           f"call ms p50 {np.percentile(lat_ms, 50):.4f} p95 {values[f'{direction}_p95_ms']:.4f} "
           f"(host clock p95 {np.percentile(lat_host, 95) * 1e3:.4f}); "
           f"set-up {setup_s:.3f} s: {phases}"]

    if trace:
        t_trace = time.perf_counter()
        prof = tracing.profile_loop(one_batch, mix["profile_batches"], on_card)
        ctx = types.SimpleNamespace(direction=direction, cfg=cfg, streams=S, profile=prof,
                                    coder=coder, on_card=on_card, device_name=dev["kind"],
                                    window_ms_per_batch=wall * 1e3 / batches, call_ms=lat_ms)
        metrics = {}
        for m in spec.metrics_of(cell["name"], "per_layer"):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=prof.busy_ms / 1e3, window_s=prof.window_ms / 1e3)
        result["breakdown"] = tracing.breakdown(prof)
        del ctx
        err.append(f"traced {prof.batches} batches: busy {prof.busy_ms:.3f} of "
                   f"{prof.window_ms:.3f} ms; profiled and read in "
                   f"{time.perf_counter() - t_trace:.3f} s")
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_of(cell["name"], "end_to_end")}
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0
    concealed = coder.metrics.plc_frames if direction == "decode" else None
    del coder, call
    if on_card:
        torch.cuda.empty_cache()

    # the comparison: every output of the checked streams, batch 0 to n - 1
    t_ref = time.perf_counter()
    jobs = [{"direction": direction, "cfg": cfg, "clip": inputs.clips[inputs.clip[s]],
             "offset": int(inputs.offset[s]), "n": n, "control": False} for s in checked]
    refs = reference.run_streams(jobs)
    ref = np.stack([r for r, _ in refs])
    if control:
        prog = np.stack([r for r, _ in reference.run_streams(
            [dict(j, control=True) for j in jobs])])
    else:
        prog = np.stack(rows, axis=1)
    numbers = compare(direction, prog, ref)
    if direction == "decode":
        numbers["concealed_frames_diff"] = abs(concealed - inputs.concealed_frames(n))
    checks = {k: (v, limits[k]) for k, v in numbers.items()}
    err.append(f"compared {len(checked)} streams x {n} batches (the reference computed "
               f"{[k for _, k in refs]} frames of each) in {time.perf_counter() - t_ref:.3f} s")
    result.update(correct=all(v <= lim for v, lim in checks.values()), metrics=metrics,
                  device=dev)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.workload(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"codecbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, checks, err = run(cell, a.seed, a.seconds, bool(a.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"codecbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in err:
        print(line, file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
