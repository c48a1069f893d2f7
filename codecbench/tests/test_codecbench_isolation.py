"""A run imports nothing of JAX or of the JAX package, the reference
nothing of the measured program, and a run without a card prints no
result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from codecbench import run

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from codecbench import run, spec
if __name__ == "__main__":
    {body}
    print(json.dumps(sorted(sys.modules)))
"""


def _modules(body: str) -> list:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cells_run_loads_no_jax():
    """A whole CPU run of a decode and an encode cell (the program, the
    traced path and the reference): no module named jax, jaxlib, flax or
    lc3jax, compared by whole top-level names."""
    mods = _modules(
        "spec.traffic = (lambda t: lambda n: dict(t(n), profile_batches=2))(spec.traffic)\n"
        "    for c in ('dec.bap16_2', 'enc.bap16_2'):\n"
        "        r = run.run(spec.workload(c), 11, 0.3, True, device='cpu', streams=2)\n"
        "        assert r[0]['correct'], r")
    assert "lc3jax_torch" in mods
    top = {m.split(".", 1)[0] for m in mods}
    assert not top & {"jax", "jaxlib", "flax", "lc3jax"}


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules("import codecbench.reference, codecbench.make_corpus, codecbench.traffic")
    top = {m.split(".", 1)[0] for m in mods}
    assert not top & {"jax", "jaxlib", "flax", "lc3jax", "lc3jax_torch", "torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lc3jax_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lc3jax.ref", object())
    monkeypatch.setitem(sys.modules, "jaxlib_probe", object())
    assert run.forbidden_modules() == ["lc3jax.ref"]


def test_a_run_without_a_card_prints_no_result(tmp_path):
    """Here (no card) and in a directory that holds only BENCHMARK.json and
    the benchmark's files: a code other than 0, no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "codecbench", tmp_path / "codecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "-m", "codecbench.run", "--workload", "dec.bap16_2",
                              "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, cwd=cwd, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "codecbench.run", "--workload", "dec.bap16_2",
                          "--seed", str(2 ** 31 + 7), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"
