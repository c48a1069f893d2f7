"""What the port's spans (`lc3jax_torch/metrics.py`) cost on a card, where a
call's and a capture's time goes by span, and whether the spans share
torch.profiler's clock there:

    python tools/span_cost.py --cells dec.bap16_2 enc.bap48_4 --seconds 10 --seed 7

For each benchmark cell, in one process on one card:

1. set-up: a coder for the cell, built and warmed up as the benchmark does
   (the process's first, so its capture loads the kernels), and its
   graph's capture split by span: `step.capture` and its children
   `step.warmup`, `step.graph` (the capture), `step.instantiate`, with the
   process's `kernels.build` and `kernels.load`;
2. the split of an unprofiled call by span: medians over `--calls` calls
   of that coder, spans on (the benchmark's readers, `codecbench/spans.py`);
3. the recorder alone: the calls one `decode` or `encode` makes into it,
   repeated, with spans on and off, less the same loop without them: the
   microseconds a call;
4. the cell's benchmark run (`codecbench.run.run`, untraced, one seed)
   once to settle the process, then once a phase with spans on or off
   (`metrics.SPANS_ON`): on, off, off, on in the cells at an even place
   of `BENCHMARK.json`'s workloads, off, on, on, off in the others, so that
   neither side always runs first;
5. a torch.profiler profile of a few calls of the coder of 1: each
   replay's kernels, linked to its `cudaGraphLaunch`, start after the
   call's `step.replay` span starts and end before its `serve.fetch` span
   ends.

Prints one JSON line a cell, and writes it to `--out` (a directory). Exits
1 where a clock check fails or a run is not correct. A profile leaves a cost
in its process, so give each cell a process of its own where the phases
matter.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import types
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from codecbench import run as bench  # noqa: E402
from codecbench import spans as readers  # noqa: E402
from codecbench import spec  # noqa: E402
from codecbench.traffic import Traffic  # noqa: E402
from lc3jax_torch import metrics, serving  # noqa: E402
from lc3jax_torch.config import FrameDuration, Lc3Config  # noqa: E402

CHILDREN = {"decode": ["serve.upload", "step.copy_in", "step.replay", "serve.fetch",
                       "serve.plc_count"],
            "encode": ["serve.upload", "step.copy_in", "step.replay", "serve.fetch"]}
CAPTURE = ("step.warmup", "step.graph", "step.instantiate")
ORDERS = (("on", "off", "off", "on"), ("off", "on", "on", "off"))


def build_coder(cfg: dict, mix: dict):
    """(the coder, its call): the mix's `coder`, a class of
    lc3jax_torch.serving with its options, for the configuration's streams."""
    named = mix["coder"]
    dur = {10: FrameDuration.MS10, 7.5: FrameDuration.MS7P5}[cfg["frame_ms"]]
    coder = getattr(serving, named["class"])(Lc3Config.new(cfg["fs"], dur), cfg["streams"],
                                             cfg["nbytes"], device="cuda", **named["options"])
    return coder, getattr(coder, named["call"])


def setup_split(coder) -> dict:
    """Each capture's ms and its children's, the kernels' spans inside it,
    and the process's kernels.build and kernels.load ms."""
    m = coder.metrics
    kernels = m.spans("kernels.build", "kernels.load")
    kids = m.spans(*CAPTURE)
    rows = []
    for cap in m.spans("step.capture"):
        row = {"key": str(cap.key), "step.capture": cap.ms}
        row.update({s.name: s.ms for s in kids if s.parent == cap.id})
        row["rest"] = cap.ms - sum(row.get(k, 0.0) for k in CAPTURE)
        row["kernels inside"] = readers.covered_ms(cap, kernels)
        rows.append(row)
    return {"captures": rows, **{s.name: s.ms for s in kernels}}


def call_split(coder, call, inputs, n: int, direction: str, calls: int) -> tuple:
    """(next batch, medians over `calls` calls of each span's ms, the root
    less its children, the sampled replays' device ms, and the readers')."""
    for _ in range(calls):
        call(inputs.batch(n))
        n += 1
    torch.cuda.synchronize()
    ctx = types.SimpleNamespace(direction=direction, coder=coder, call_ms=np.ones(calls))
    root = f"serve.{direction}"
    kept = readers.window_calls(ctx) or []
    out = {"calls": len(kept)}
    for name in [root] + CHILDREN[direction]:
        vals = [readers.total_ms(c[name]) for c in kept if name in c]
        out[name] = statistics.median(vals) if vals else None
    out["root less children"] = statistics.median(
        c[root][0].ms - sum(readers.total_ms(c.get(k, ())) for k in CHILDREN[direction])
        for c in kept) if kept else None
    dev = [s.device_ms for c in kept for s in c.get("step.replay", ()) if s.device_ms is not None]
    out["replay_device_samples"] = len(dev)
    for k in ("host_ms", "upload_ms", "launch_ms", "replay_device_ms", "syncs_per_call"):
        out[f"reader {k}"] = getattr(readers, k)(ctx)
    return n, out


def recorder_us(direction: str, reps: int) -> dict:
    """Microseconds a call of the recorder's own work: the root, each child
    span with its caller's clock read, the replay's edge sampling; with
    spans on, off, and on without the edge sampling; the best of four
    passes of `reps` calls on one recorder, less the bare loop."""
    root, kids = f"serve.{direction}", CHILDREN[direction]
    device = torch.device("cuda", torch.cuda.current_device())

    def loop(m, edges=True):
        t0 = time.perf_counter()
        for _ in range(reps):
            t_call = m.begin()
            for name in kids:
                t = time.time_ns()
                if name == "step.replay" and edges:
                    edge = m.edge_start(device)
                    if edge is not None:
                        edge[0][1].record()
                    m.span(name, t, edge)
                else:
                    m.span(name, t)
            m.end(root, t_call)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    def skeleton():
        t0 = time.perf_counter()
        for _ in range(reps):
            for name in kids:
                if name == "step.replay":
                    pass
        return (time.perf_counter() - t0) / reps * 1e6

    def best(edges=True):  # one recorder, its event pool made in the first pass
        m = metrics.CodecMetrics()
        return min(loop(m, edges) for _ in range(4))

    base = min(skeleton() for _ in range(3))
    on, no_edges = best(), best(edges=False)
    metrics.SPANS_ON = False
    try:
        off = best()
    finally:
        metrics.SPANS_ON = True
    return {"on_us": on - base, "off_us": off - base, "on_without_edges_us": no_edges - base,
            "loop_us": base}


def phase(cell: dict, seed: int, seconds: float, on: bool) -> dict:
    """One untraced run of the cell by the benchmark, spans on or off: its
    end-to-end metrics, `correct`, and its line of numbers."""
    metrics.SPANS_ON = on
    try:
        result, _, err = bench.run(cell, seed, seconds, False)
    finally:
        metrics.SPANS_ON = True
    return {"spans": "on" if on else "off", "correct": result["correct"],
            **{k: v["value"] for k, v in result["metrics"].items()}, "line": err[0]}


def clock_check(coder, call, inputs, n: int, direction: str, calls: int = 8) -> dict:
    """The profiled calls' kernels against their spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call(inputs.batch(n))
            n += 1
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launches = {e.correlation_id(): e for e in events if e.name() == "cudaGraphLaunch"}
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    kernels = defaultdict(list)  # the card's spans by the launch whose correlation id they carry
    for e in on_card:
        if e.correlation_id() in launches:
            kernels[e.correlation_id()].append(e)
    roots = [r for r in coder.metrics.spans(f"serve.{direction}") if r.profiled][-calls:]
    by_call = defaultdict(dict)
    for s in coder.metrics.spans("step.replay", "serve.fetch"):
        by_call[s.call][s.name] = s
    rows = []
    for r in roots:
        rep, fetch = by_call[r.id].get("step.replay"), by_call[r.id].get("serve.fetch")
        if rep is None or fetch is None:
            continue
        hit = [c for c, e in launches.items() if rep.start_ns <= e.start_ns() <= rep.end_ns]
        ks = [k for c in hit for k in kernels[c]]
        if not ks:
            rows.append({"launch_in_replay_span": bool(hit), "kernels": 0})
            continue
        first = min(k.start_ns() for k in ks)
        last = max(k.start_ns() + k.duration_ns() for k in ks)
        rows.append({"launch_in_replay_span": len(hit) == 1, "kernels": len(ks),
                     "first_kernel_after_replay_start_us": (first - rep.start_ns) / 1e3,
                     "fetch_end_after_last_kernel_us": (fetch.end_ns - last) / 1e3,
                     "past_fetch_end": sorted({k.name() for k in ks
                                               if k.start_ns() + k.duration_ns() > fetch.end_ns})})
    ok = bool(rows) and all(r["launch_in_replay_span"] and r["kernels"] > 0
                            and r["first_kernel_after_replay_start_us"] > 0
                            and r["fetch_end_after_last_kernel_us"] > 0 for r in rows)
    # where no kernel is linked: whether the profile held none, or held them unlinked
    return {"ok": ok, "profiled_roots": len(roots), "launches": len(launches),
            "device_events": len(on_card), "device_events_linked": sum(map(len, kernels.values())),
            "calls": rows}


def one_cell(name: str, seed: int, seconds: float, calls: int, reps: int) -> dict:
    cell = spec.workload(name)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    direction = mix["direction"]
    out = {"cell": name, "device": torch.cuda.get_device_name(0)}
    inputs = Traffic(cfg, mix, seed, cfg["streams"])
    coder, call = build_coder(cfg, mix)
    n = 0
    for _ in range(mix["warmup_batches"]):  # the first captures the graph
        call(inputs.batch(n))
        n += 1
    torch.cuda.synchronize()
    out["setup"] = setup_split(coder)
    n, out["split"] = call_split(coder, call, inputs, n, direction, calls)
    out["recorder"] = recorder_us(direction, reps)
    out["settle"] = phase(cell, seed, seconds, True)
    out["phases"] = [phase(cell, seed, seconds, mode == "on")
                     for mode in ORDERS[spec.benchmark()["workloads"].index(cell) % 2]]
    rate = f"{direction}_x_realtime"
    mean = lambda side: statistics.fmean(p[rate] for p in out["phases"] if p["spans"] == side)
    call_s = cfg["streams"] * cfg["frame_ms"] / 1e3  # audio seconds a call
    out["on_less_off_call_us"] = (call_s / mean("on") - call_s / mean("off")) * 1e6
    out["x_realtime_on_over_off"] = mean("on") / mean("off")
    out["clock"] = clock_check(coder, call, inputs, n, direction)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=["dec.bap16_2", "enc.bap48_4"])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--calls", type=int, default=1000, help="calls of the split")
    ap.add_argument("--reps", type=int, default=20000)
    ap.add_argument("--out", default="build/span_cost")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    Path(a.out).mkdir(parents=True, exist_ok=True)
    ok = True
    for name in a.cells:
        res = one_cell(name, a.seed, a.seconds, a.calls, a.reps)
        line = json.dumps(res)
        (Path(a.out) / f"span_cost_{name}.json").write_text(line + "\n")
        print(line, flush=True)
        ok &= res["clock"]["ok"] and all(p["correct"] for p in [res["settle"], *res["phases"]])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
