"""Each cell's loop at a few streams on the CPU (`device="cpu"` is a test
hook: the measurement path asks for a card), and the check that decides
`correct`: sound runs pass it; the control (the reference in bfloat16 in
the program's place) and planted faults of the timed path fail it."""

import numpy as np
import pytest

from codecbench import run, spec
from lc3jax_torch import serving

CELLS = ["enc.bap48_4", "dec.bap16_2", "dec.bap48_4", "enc.bap16_2"]
SEED = 2 ** 31 + 99


def _run(cell, seconds=0.5, trace=False, control=False, streams=8):
    result, checks, err = run.run(spec.workload(cell), SEED, seconds, trace, device="cpu",
                                  streams=streams, control=control)
    return result, checks


@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_loop_is_correct(cell):
    result, checks = _run(cell)
    assert result["correct"], checks
    names = {m["name"] for m in spec.metrics_of(cell, "end_to_end")}
    assert set(result["metrics"]) == names and "setup_s" in names
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_traced_run_reads_its_per_layer_metrics(monkeypatch):
    monkeypatch.setattr(spec, "traffic", (lambda t: lambda n: dict(t(n), profile_batches=2))(
        spec.traffic))
    result, checks = _run("dec.bap16_2", trace=True)
    assert result["correct"], checks
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    assert "decode.step_device_ms" in result["metrics"]
    assert result["metrics"]["decode.call_p95_ms"]["value"] > 0
    assert "decode.graph_nodes" not in result["metrics"]  # no graph without a card


@pytest.mark.parametrize("cell", ["dec.bap16_2", "enc.bap16_2"])
def test_the_control_is_not_correct(cell):
    result, checks = _run(cell, control=True)
    assert not result["correct"], checks


def _planted(monkeypatch, direction, fault):
    cls, name = ((serving.BatchDecoder, "decode") if direction == "decode"
                 else (serving.BatchEncoder, "encode"))
    real = getattr(cls, name)

    def broken(self, x, *a, **k):
        if fault == "state_unchanged":  # every call from the state the coder started with
            if not hasattr(self, "_first_state"):
                import copy
                self._first_state = copy.deepcopy(self.state)
            self.state = self._first_state
        out = np.array(real(self, x, *a, **k))
        if fault == "half_the_batch":  # the second half of the streams left out
            out[out.shape[0] // 2:] = 0
        elif fault == "answer_altered":  # one sample (by 64 LSB) or byte of each output
            out[:, -1] ^= 0x40
        return out

    monkeypatch.setattr(cls, name, broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["dec.bap16_2", "enc.bap48_4"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _planted(monkeypatch, spec.traffic(spec.workload(cell)["traffic"])["direction"], fault)
    result, checks = _run(cell)
    assert not result["correct"], (fault, checks)


@pytest.mark.parametrize("traffic,cls,options", [
    ("closed.encode", serving.BatchEncoder, {"device_pack": False}),
    ("closed.decode", serving.BatchDecoder, {}),
])
def test_the_mix_names_the_coder_and_its_call(traffic, cls, options):
    mix = spec.traffic(traffic)
    mix["coder"] = dict(mix["coder"], options=options)
    coder, call = run._coder(spec.config("bap16_2.s2048"), mix, 4, "cpu")
    assert type(coder) is cls and call.__name__ == mix["coder"]["call"]
    assert all(getattr(coder, k) == v for k, v in options.items())


def test_a_loop_the_harness_does_not_run_is_refused(monkeypatch):
    monkeypatch.setattr(spec, "traffic", (lambda t: lambda n: dict(t(n), loop="paced"))(
        spec.traffic))
    with pytest.raises(ValueError, match="paced"):
        _run("dec.bap16_2")
