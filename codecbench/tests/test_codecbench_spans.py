"""The readers of the program's own spans and counters (`codecbench/spans.py`,
`metrics/{decode,encode}.*_ms.py`, `*.syncs_per_call.py`, `setup.*.py`) on
the CPU: a traced run reports each of its cell's metrics that a run without
a card can have, the profile's readers still read an unchanged `trace.py`,
and a program that records no spans gives no reading and no error."""

import hashlib
import types

import numpy as np
import pytest

from codecbench import run, spec, spans
from codecbench.tests.test_codecbench_check import SEED

# codecbench/trace.py as the benchmark was accepted with it: the profile's
# readers (idle share, step device time, rooflines, breakdown) read it
TRACE_SHA256 = "194d0786b93d744b9cfa4e7e0ea2f0592d8b34c6021660c9d5fe58a82ca83316"
NO_CARD = {"decode.replay_device_ms", "encode.replay_device_ms", "setup.capture_ms",
           "setup.kernels_ms"}


@pytest.mark.parametrize("cell", ["dec.bap16_2", "enc.bap16_2"])
def test_a_traced_run_reads_the_programs_spans(monkeypatch, cell):
    monkeypatch.setattr(spec, "traffic", (lambda t: lambda n: dict(t(n), profile_batches=2))(
        spec.traffic))
    result, checks, _ = run.run(spec.workload(cell), SEED, 0.5, True, device="cpu", streams=8)
    assert result["correct"], checks
    got = result["metrics"]
    direction = cell.split(".")[0] + "ode"
    new = {m["name"] for m in spec.metrics_of(cell, "per_layer")
           if m["source"] in ("program_span", "program_counter") and "graph_nodes" not in m["name"]}
    assert new == {f"{direction}.{n}" for n in ("host_ms", "upload_ms", "launch_ms",
                                                 "replay_device_ms")} | {
        "setup.capture_ms", "setup.kernels_ms"} | ({"decode.syncs_per_call"}
                                                   if direction == "decode" else set())
    for name in new - NO_CARD:
        assert got[name]["value"] > 0, name
    assert not NO_CARD & set(got)  # no card: no device edges, no graph, no kernels
    if direction == "decode":
        assert got["decode.syncs_per_call"]["value"] == 2
    assert got[f"{direction}.host_ms"]["value"] > got[f"{direction}.launch_ms"]["value"]
    assert f"{direction}.step_device_ms" in got and f"{direction}.device_idle_pct" in got
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_profiles_readers_read_an_unchanged_trace_py():
    assert hashlib.sha256((spec.HERE / "trace.py").read_bytes()).hexdigest() == TRACE_SHA256


def test_a_program_without_spans_gives_no_reading():
    """A coder whose recorder has counters only (no `spans`, `calls` or
    `host_syncs`) reads nothing and raises nothing."""
    bare = types.SimpleNamespace(plc_frames=0, frames_decoded=0)
    ctx = types.SimpleNamespace(direction="decode", coder=types.SimpleNamespace(metrics=bare),
                                call_ms=np.ones(4))
    for name in ("host_ms", "upload_ms", "launch_ms", "replay_device_ms", "syncs_per_call",
                 "capture_ms", "kernels_ms"):
        assert getattr(spans, name)(ctx) is None, name
    for m in spec.benchmark()["per_layer"]:
        if m["source"] in ("program_span",) or m["name"].endswith("syncs_per_call"):
            assert spec.reader(m["name"])(ctx) is None, m["name"]
