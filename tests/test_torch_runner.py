"""lc3jax_torch.runner (the WAV copy and the CLI) against lc3jax.runner: the
same WAV bytes, the oracle's frames from `encode`, PCM within 1 LSB of the
oracle's from `decode`, the oracle's side-info lines from `inspect`. The JAX
CLI runs only its host paths here (--oracle, compare, inspect)."""

import numpy as np
import pytest
import torch

from lc3jax.runner import cli as jcli
from lc3jax.runner import wav as jwav
from lc3jax_torch.runner import cli, wav

NF, NBYTES, NFRAMES = 480, 120, 6


def test_wav_equals_lc3jax_wav(tmp_path):
    """Byte-identical files, and each package reads the other's."""
    pcm = (1000 * np.random.default_rng(0).standard_normal((480, 3))).astype(np.int16)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    wav.write_wav(a, pcm, 32000)
    jwav.write_wav(b, pcm, 32000)
    assert open(a, "rb").read() == open(b, "rb").read()
    for got, rate in (wav.read_wav(b), jwav.read_wav(a)):
        assert rate == 32000 and np.array_equal(got, pcm)


@pytest.fixture(scope="module")
def files(tmp_path_factory, goldens):
    """A 2-channel WAV of stream50's first frames (channel 1 inverted), the
    port CLI's and the JAX oracle CLI's encodes of it."""
    g = goldens("stream50")
    d = tmp_path_factory.mktemp("cli")
    pcm = g["pcm_in"][:NFRAMES].reshape(-1)
    samples = np.stack([pcm, -np.maximum(pcm, -32767)], 1)
    paths = {k: str(d / k) for k in ("in.wav", "port.lc3", "oracle.lc3")}
    wav.write_wav(paths["in.wav"], samples, 48000)
    assert cli.main(["--device", "cpu", "encode", paths["in.wav"], paths["port.lc3"],
                     "--nbytes", str(NBYTES)]) == 0
    assert jcli.main(["encode", paths["in.wav"], paths["oracle.lc3"], "--nbytes",
                      str(NBYTES), "--oracle"]) == 0
    return paths, g


def test_cli_encode_equals_the_oracle(files, capsys):
    """Every frame byte-exact: channel 0 to stream50's stored payloads, both
    channels to the JAX CLI's oracle file, interleaved per frame."""
    paths, g = files
    data = np.frombuffer(open(paths["port.lc3"], "rb").read(), np.uint8)
    frames = data.reshape(NFRAMES, 2, NBYTES)
    assert np.array_equal(frames[:, 0], g["payloads"][:NFRAMES])
    capsys.readouterr()
    assert jcli.main(["compare", paths["port.lc3"], paths["oracle.lc3"]]) == 0
    assert cli.main(["compare", paths["port.lc3"], paths["oracle.lc3"]]) == 0
    assert capsys.readouterr().out.splitlines() == [f"identical ({data.size} bytes)"] * 2


def test_cli_decode_within_one_lsb(files, tmp_path):
    """Decode of the 2-channel file: within 1 LSB of the JAX CLI's oracle
    decode, channel 0 of stream50's stored PCM."""
    paths, g = files
    port, oracle = str(tmp_path / "port.wav"), str(tmp_path / "oracle.wav")
    args = ["--rate", "48000", "--channels", "2", "--nbytes", str(NBYTES)]
    assert cli.main(["--device", "cpu", "decode", paths["oracle.lc3"], port, *args]) == 0
    assert jcli.main(["decode", paths["oracle.lc3"], oracle, *args, "--oracle"]) == 0
    got, rate = wav.read_wav(port)
    want, _ = jwav.read_wav(oracle)
    assert rate == 48000 and got.shape == (NFRAMES * NF, 2)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert np.abs(got[:, 0].astype(int) - g["pcm_out"][:NFRAMES].reshape(-1)).max() <= 1


def test_cli_compare_reports_the_first_difference(files, tmp_path, capsys):
    paths, _ = files
    data = bytearray(open(paths["oracle.lc3"], "rb").read())
    data[200] ^= 1
    data[300] ^= 4
    other = tmp_path / "other.lc3"
    other.write_bytes(bytes(data[:-5]))
    capsys.readouterr()
    assert cli.main(["compare", paths["oracle.lc3"], str(other)]) == 1
    port = capsys.readouterr().out
    assert jcli.main(["compare", paths["oracle.lc3"], str(other)]) == 1
    assert port == capsys.readouterr().out
    assert port.splitlines()[1] == "2 differing bytes; first at 200"


@pytest.mark.parametrize("stream", ["stream50", "8000_7.5ms_30"])
def test_cli_inspect_equals_lc3jax(stream, goldens, tmp_path, capsys):
    """The port's side-info reader prints the JAX CLI's lines (two TNS
    filters at 48 kHz, one at 8 kHz); a corrupt frame prints CORRUPT (the
    oracle adds its exception's text)."""
    if stream == "stream50":
        pl, opts = goldens("stream50")["payloads"][:NFRAMES].copy(), []
    else:
        pl = goldens("torch_config_parity")[f"{stream}_payloads"][:NFRAMES].copy()
        opts = ["--rate", "8000", "--duration", "7.5"]
    pl[2] = 255  # bandwidth index or lastnz out of range: corrupt side info
    pl[4] = np.random.default_rng(5).integers(0, 256, pl.shape[1])
    path = tmp_path / "mono.lc3"
    path.write_bytes(pl.tobytes())
    args = ["inspect", str(path), "--nbytes", str(pl.shape[1]), *opts]
    capsys.readouterr()
    assert cli.main(["--device", "cpu", *args]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jcli.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert len(port) == len(want) == NFRAMES
    corrupt = [i for i, line in enumerate(want) if "CORRUPT" in line]
    assert 2 in corrupt
    for i, (a, b) in enumerate(zip(port, want)):
        if i in corrupt:
            assert a == f"frame {i}: CORRUPT (side info)", a
        else:
            assert a == b


@pytest.mark.parametrize("cmd", ["encode", "decode", "inspect"])
def test_cli_without_a_card_raises(files, cmd, monkeypatch, tmp_path):
    paths, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"encode": [cmd, paths["in.wav"], str(tmp_path / "x.lc3")],
            "decode": [cmd, paths["port.lc3"], str(tmp_path / "x.wav"), "--channels", "2"],
            "inspect": [cmd, paths["port.lc3"]]}[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + ["--nbytes", str(NBYTES)])
