"""lc3jax_torch stays free of JAX, and refuses to fall back where the
CUDA toolchain or card is missing."""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_DECODE_WITHOUT_JAX = """
import sys
import numpy as np
import lc3jax_torch
from lc3jax_torch.serving import BatchDecoder
g = np.load("tests/goldens/stream50.npz")
dec = BatchDecoder(lc3jax_torch.Lc3Config.new(48000, lc3jax_torch.FrameDuration.MS10), 2, 120)
pcm = dec.decode(g["payloads"][:2])
assert pcm.shape == (2, 480) and pcm.dtype == np.int16
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok")
"""


def test_package_decodes_without_importing_jax():
    res = subprocess.run([sys.executable, "-c", _DECODE_WITHOUT_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from lc3jax_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "CUDA_DEFAULT", tmp_path / "no-cuda-either")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()
    assert not (tmp_path / "build").exists()


def test_chip_smoke_fails_without_a_card(capsys):
    """No CUDA device here: chip_smoke exits non-zero, with no result line."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_alone(tmp_path):
    """As the only file of a directory, chip_smoke.py exits non-zero with no
    result line."""
    script = Path(shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
