"""Where the benchmark finds what it runs, by name: the cells and metrics
in `BENCHMARK.json` at the checkout's root, and under `codecbench/`

    configs/<config>.json     a configuration: geometry, frame size, streams
    traffic/<traffic>.json    a traffic mix: direction, coder and call, content, pools
    limits/<cell>.json        a cell's limits on the numbers `correct` compares
    metrics/<metric>.py       a per-layer metric's reader
    corpus/...                a decode mix's frames (its `corpus` pattern)

A new cell, configuration, mix or metric is a new file and an entry in
`BENCHMARK.json`; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    cells = {w["name"]: w for w in benchmark()["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (cells: {', '.join(cells)})")
    return cells[name]


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    """{number compared: its limit} of a cell."""
    return _json(HERE / "limits" / f"{cell}.json")["limits"]


def corpus_path(cfg: dict, mix: dict) -> Path:
    return HERE / mix["corpus"].format(**cfg)


def metrics_of(cell: str, kind: str) -> list:
    """The cell's metrics of one kind ("end_to_end" or "per_layer"): those
    that list the cell under `workloads`, and those without the key whose
    `moves` metric the cell reports."""
    bench = benchmark()
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]


def reader(metric: str):
    """The `read(run)` function of a per-layer metric's reader file."""
    path = HERE / "metrics" / f"{metric}.py"
    s = importlib.util.spec_from_file_location(f"codecbench_metric_{metric.replace('.', '_')}",
                                               path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read
