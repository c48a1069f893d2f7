"""lc3jax_torch stays free of JAX and of the lc3jax package, runs on the
card unless asked for the CPU, and refuses to fall back where the CUDA
toolchain or card is missing."""

import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_CODEC_WITHOUT_JAX = """
import sys
import numpy as np
import lc3jax_torch
from lc3jax_torch.serving import BatchDecoder, BatchEncoder
cfg = lc3jax_torch.Lc3Config.new(48000, lc3jax_torch.FrameDuration.MS10)
g = np.load("tests/goldens/stream50.npz")
pcm = BatchDecoder(cfg, 2, 120, device="cpu").decode(g["payloads"][:2])
assert pcm.shape == (2, 480) and pcm.dtype == np.int16
frames = BatchEncoder(cfg, 2, 120, device="cpu").encode(g["pcm_in"][:2])
assert frames.shape == (2, 120) and frames.dtype == np.uint8
fused = BatchEncoder(cfg, 2, 120, device="cpu", device_pack=True).encode(g["pcm_in"][:2])
assert np.array_equal(fused, frames)
host = BatchDecoder(cfg, 2, 120, device="cpu", device_parse=False)
assert np.array_equal(host.decode(g["payloads"][:2]), pcm)
streamed = BatchDecoder(cfg, 2, 120, device="cpu", device_parse=False).decode_stream(
    [g["payloads"][:2]], pipeline=True)
assert np.array_equal(streamed[0], pcm)
import tempfile, os
from lc3jax_torch.checkpoint import load_state, save_state
from lc3jax_torch.dsp.decoder import decoder_init
with tempfile.TemporaryDirectory() as d:
    save_state(os.path.join(d, "s.npz"), host.state)
    back = load_state(os.path.join(d, "s.npz"), decoder_init(cfg, 2, "cpu"))
assert np.array_equal(back.ltpf.hist_x.numpy(), host.state.ltpf.hist_x.numpy())
import torch
from lc3jax_torch import parallel, profiling
from lc3jax_torch.coding.device import decode_bytes_step
mesh = parallel.stream_mesh(["cpu"] * 2)
step = parallel.make_sharded_decode_bytes_step(cfg, 120, mesh)
st, sharded = step(parallel.sharded_decoder_init(cfg, 2, mesh), g["payloads"][:2])
assert np.array_equal(sharded.gather().numpy(), pcm)
from lc3jax_torch.coding.host_parse import HostParser
from lc3jax_torch.dsp.decoder import make_decode_step
parser = HostParser(cfg, "cpu")
parser.parse(g["payloads"][:2])
st, compiled = make_decode_step(cfg, 120 * 8, "cpu")(decoder_init(cfg, 2, "cpu"), parser.upload())
assert np.array_equal(compiled.numpy(), pcm)
from lc3jax_torch.api import Lc3Decoder, Lc3Encoder, decoder_ram_bytes
frame = Lc3Encoder(1, lc3jax_torch.FrameDuration.MS10, 48000, device="cpu").encode_frame(
    0, g["pcm_in"][0], 120)
assert frame == g["payloads"][0].tobytes()
assert Lc3Decoder(1, lc3jax_torch.FrameDuration.MS10, 48000, device="cpu").decode_frame(
    16, 0, b"").shape == (480,)
assert decoder_ram_bytes(1, lc3jax_torch.FrameDuration.MS10, 48000) == 27564
rec = BatchDecoder(cfg, 2, 120, device="cpu")
rec.decode(g["payloads"][:2])
spans = rec.metrics.spans("serve.decode", "step.replay")
assert [s.name for s in spans] == ["serve.decode", "step.replay"] and spans[0].ms > 0
assert profiling.union_ms([]) == 0.0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] == "lc3jax" or m.split(".")[0].startswith("jax"))
assert not loaded, loaded
print("ok")
"""


def test_package_decodes_without_importing_jax():
    """A decode (fused and host-parse), a pipelined decode_stream, an encode
    (host pack and fused), a checkpoint round trip, a decode sharded in two
    with `parallel` and `profiling` imported, a `make_decode_step`
    (`compiled`), the `api` facade and a decode's spans (`metrics`), on the
    CPU, load no lc3jax and no jax module."""
    res = subprocess.run([sys.executable, "-c", _CODEC_WITHOUT_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


_IMPORT_LC3JAX = re.compile(r"^\s*(import\s+lc3jax\b(?!_torch)|from\s+lc3jax\b(?!_torch))",
                            re.MULTILINE)


def test_no_source_imports_lc3jax():
    """No module of the port and not chip_smoke.py imports the JAX package."""
    files = sorted((ROOT / "lc3jax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT_LC3JAX.search(f.read_text())]
    assert len(files) > 10 and not offenders, offenders
    assert ROOT / "lc3jax_torch" / "api.py" in files


def test_port_data_equals_jax_data():
    """The port's copy of the spec tables is the JAX package's file."""
    a = np.load(ROOT / "lc3jax" / "data" / "tables.npz")
    b = np.load(ROOT / "lc3jax_torch" / "data" / "tables.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("entry", ["BatchDecoder", "BatchDecoder-host_parse", "BatchEncoder",
                                   "BatchEncoder-device_pack", "encoder_init", "decoder_init",
                                   "stream_mesh", "sharded_decoder_init", "make_decode_step",
                                   "make_encode_step", "make_decode_bytes_frames",
                                   "make_decode_bytes_step", "Lc3Encoder", "Lc3Decoder"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Built without `device`, an entry point, state constructor or stream
    mesh asks for CUDA: where no card is present it raises rather than
    carrying on on the CPU."""
    from lc3jax_torch import api, serving
    from lc3jax_torch.coding.device import make_decode_bytes_step
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.dsp.decoder import decoder_init, make_decode_step
    from lc3jax_torch.dsp.encoder import encoder_init, make_encode_step
    from lc3jax_torch.dsp.streaming import make_decode_bytes_frames
    from lc3jax_torch.parallel import sharded_decoder_init, stream_mesh, tree_leaves

    mesh = lambda **kw: stream_mesh([kw["device"]] if kw else None)

    make = {
        "BatchDecoder": lambda **kw: serving.BatchDecoder(cfg, 2, 40, **kw),
        "BatchDecoder-host_parse": lambda **kw: serving.BatchDecoder(cfg, 2, 40, device_parse=False,
                                                                     **kw),
        "BatchEncoder": lambda **kw: serving.BatchEncoder(cfg, 2, 40, **kw),
        "BatchEncoder-device_pack": lambda **kw: serving.BatchEncoder(cfg, 2, 40, device_pack=True,
                                                                      **kw),
        "encoder_init": lambda **kw: encoder_init(cfg, 2, **kw),
        "decoder_init": lambda **kw: decoder_init(cfg, 2, **kw),
        "stream_mesh": mesh,
        "sharded_decoder_init": lambda **kw: sharded_decoder_init(cfg, 2, mesh(**kw)),
        "make_decode_step": lambda **kw: make_decode_step(cfg, 320, **kw),
        "make_encode_step": lambda **kw: make_encode_step(cfg, 40, **kw),
        "make_decode_bytes_frames": lambda **kw: make_decode_bytes_frames(cfg, 40, **kw),
        "make_decode_bytes_step": lambda **kw: make_decode_bytes_step(cfg, 40, **kw),
        "Lc3Encoder": lambda **kw: api.Lc3Encoder(2, FrameDuration.MS10, 16000, **kw),
        "Lc3Decoder": lambda **kw: api.Lc3Decoder(2, FrameDuration.MS10, 16000, **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Lc3Config.new(16000, FrameDuration.MS10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    built = make(device="cpu")
    if entry.startswith(("Batch", "Lc3")):
        assert built.device.type == "cpu"
    elif entry.startswith("make_"):
        assert built.cache.device.type == "cpu"
    elif entry == "stream_mesh":
        assert built.devices == (torch.device("cpu"),)
    else:
        tensors = [v for v in tree_leaves(built) if isinstance(v, torch.Tensor)]
        assert tensors and all(t.device.type == "cpu" for t in tensors)


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


def test_host_packer_build_failure_raises(monkeypatch, tmp_path):
    """A packer that does not compile raises; there is no Python packer."""
    from lc3jax_torch.coding import host_pack

    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(host_pack, "SOURCE", bad)
    monkeypatch.setattr(host_pack, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_pack, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build"):
        host_pack.load()


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


_ENTRY_CALL = re.compile(r"\blc3t_\w+\(")
_LAUNCH = re.compile(r'_build\.launch\(\s*"(lc3t_\w+)"')


def test_wrappers_share_one_launch_path():
    """Every kernel wrapper launches through `_build.launch` and allocates
    from an input with `new_empty`: no module calls a C entry itself, builds a
    Stream object (`_build.stream_ptr` is gone), enters `torch.cuda.device`
    (only `_build.launch` does, for a tensor off the current device) or
    allocates with `torch.empty`."""
    from lc3jax_torch import _build

    build_src = (ROOT / "lc3jax_torch" / "_build.py").read_text()
    assert not hasattr(_build, "stream_ptr") and "stream_ptr" not in build_src
    launch_body = build_src[build_src.index("def launch("):]
    assert build_src.count("torch.cuda.device(") == launch_body.count("torch.cuda.device(") == 1
    launched = set()
    for f in sorted((ROOT / "lc3jax_torch").rglob("*.py")):
        if f.name == "_build.py":
            continue
        src = f.read_text()
        name = str(f.relative_to(ROOT))
        for bad in ("stream_ptr", "torch.cuda.device(", "torch.empty(", "empty_like(",
                    "current_stream(", "_build.lib()"):
            assert bad not in src, (name, bad)
        assert not _ENTRY_CALL.search(_LAUNCH.sub("", src)), name
        found = _LAUNCH.findall(src)
        launched.update(found)
        if found:
            assert "new_empty(" in src, name
    assert launched == set(_build.SIGNATURES), launched ^ set(_build.SIGNATURES)
