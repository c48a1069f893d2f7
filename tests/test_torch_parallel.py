"""lc3jax_torch.parallel on a mesh of 8 CPU shards: every sharded step equal
to the port's unsharded step, the encoded bytes equal to the oracle's, the
shard layout equal to JAX's, and a two-process gloo run (the counterparts
of tests/test_parallel.py and tests/test_multihost.py).

Streams carry stream50 at four frame offsets (stream s starts at frame
10 * (s % 4)), so shards hold different content; the streams at offset 0
encode the oracle's own frames. Run as a script, this file is one process
of the two-process test (JAX is imported only by the tests that compare
with it, so that a worker starts without it):

    python tests/test_torch_parallel.py <host:port> <rank> <payloads.npz> <out.npz>
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
S, T, NBYTES = 16, 3, 120
OFFSETS = 10 * (np.arange(S) % 4)


def _cfg(fs: int = 48000):
    from lc3jax_torch.config import FrameDuration, Lc3Config

    return Lc3Config.new(fs, FrameDuration.MS10)


def _mesh(n: int = 8):
    from lc3jax_torch.parallel import stream_mesh

    return stream_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def s50():
    return np.load(ROOT / "tests" / "goldens" / "stream50.npz")


def _payloads(s50, t: int) -> np.ndarray:
    return np.ascontiguousarray(s50["payloads"][OFFSETS + t])


def _pcm(s50, t: int) -> torch.Tensor:
    return torch.as_tensor(s50["pcm_in"][OFFSETS + t])


def assert_trees_equal(a, b, path="") -> None:
    """Leaf by leaf: tensors torch.equal (dtype and shape included), other
    leaves ==."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            assert_trees_equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _golden_bytes(s50, fields: dict, t: int) -> None:
    """The streams at offset 0 pack (C++ host packer) to the oracle's frame t."""
    from lc3jax_torch.coding import host_pack
    from lc3jax_torch.convert import encoder_fields_to_numpy

    packed = host_pack.pack_frames(_cfg(), encoder_fields_to_numpy(fields), NBYTES)
    assert np.array_equal(packed[OFFSETS == 0], np.tile(s50["payloads"][t], (S // 4, 1)))


@pytest.mark.parametrize("axis", [0, 1])
def test_shard_layout_equals_jax(axis):
    """Shard i holds the rows of the i-th of JAX's addressable shards over
    the 8 virtual CPU devices (jax.device_put only)."""
    import jax

    from lc3jax.parallel import shard_streams as jax_shard_streams
    from lc3jax.parallel import stream_mesh as jax_stream_mesh

    from lc3jax_torch.parallel import shard_streams

    x = np.arange(S * 3 * 5, dtype=np.float32).reshape((S, 3, 5) if axis == 0 else (3, S, 5))
    jmesh = jax_stream_mesh(jax.devices()[:8])
    jarr = jax_shard_streams(jmesh, x, axis)
    by_device = {sh.device: sh for sh in jarr.addressable_shards}
    got = shard_streams(_mesh(), x, axis)
    assert len(got.shards) == 8 and got.axis == axis
    for i, dev in enumerate(jmesh.devices.tolist()):
        sh = by_device[dev]
        assert np.array_equal(got.shards[i].numpy(), np.asarray(sh.data))
        assert np.array_equal(got.shards[i].numpy(), x[sh.index])
    assert np.array_equal(got.gather().numpy(), x)


def test_uneven_streams_raise():
    """S = 20 over 8 devices raises ValueError in both packages."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from lc3jax.parallel import stream_mesh as jax_stream_mesh
    from lc3jax_torch.parallel import shard_streams, sharded_decoder_init

    x = np.zeros((20, 4), np.float32)
    with pytest.raises(ValueError):
        jax.device_put(x, NamedSharding(jax_stream_mesh(jax.devices()[:8]),
                                        PartitionSpec("streams")))
    with pytest.raises(ValueError, match="split evenly"):
        shard_streams(_mesh(), x)
    with pytest.raises(ValueError, match="split evenly"):
        sharded_decoder_init(_cfg(), 20, _mesh())


def test_leaf_rules():
    """pack_tables [rows, S] split on the axis after the stream axis; rank-0
    tensors and Python scalars on every shard, back once."""
    from lc3jax_torch.parallel import shard_streams

    tree = {"x_q": torch.arange(S * 4).reshape(S, 4),
            "quant_pack_tables": torch.arange(5 * S).reshape(5, S),
            "nbits_bw": 3, "scale": torch.tensor(2.5)}
    got = shard_streams(_mesh(), tree)
    for i, sh in enumerate(got.shards):
        assert torch.equal(sh["x_q"], tree["x_q"][2 * i : 2 * i + 2])
        assert torch.equal(sh["quant_pack_tables"], tree["quant_pack_tables"][:, 2 * i : 2 * i + 2])
        assert sh["nbits_bw"] == 3 and torch.equal(sh["scale"], tree["scale"])
    assert_trees_equal(got.gather(), tree)


def test_sharded_decode_step(s50):
    """decode_step on host-parsed fields, unsharded inputs resharded by the
    step; PCM and the gathered state equal the unsharded step's; the state
    passed in is donated."""
    from lc3jax_torch.coding.host_parse import HostParser
    from lc3jax_torch.dsp.decoder import decode_step, decoder_init
    from lc3jax_torch.parallel import make_sharded_decode_step, sharded_decoder_init

    cfg = _cfg()
    parser = HostParser(cfg)
    st1, st8 = decoder_init(cfg, S, "cpu"), sharded_decoder_init(cfg, S, _mesh())
    step = make_sharded_decode_step(cfg, NBYTES * 8, _mesh())
    for t in range(2):
        parser.parse(_payloads(s50, t))
        frames = parser.upload()
        st1, pcm1 = decode_step(cfg, NBYTES * 8, st1, frames)
        old, (st8, pcm8) = st8, step(st8, frames)
        assert torch.equal(pcm8.gather(), pcm1)
    assert_trees_equal(st8.gather(), st1)
    with pytest.raises(RuntimeError, match="donated"):
        old.gather()
    assert len({bytes(p.numpy()) for p in pcm8.shards}) > 1  # the shards differ


def test_sharded_encode_step(s50):
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init
    from lc3jax_torch.parallel import (make_sharded_encode_step, shard_streams,
                                       sharded_encoder_init)

    cfg, mesh = _cfg(), _mesh()
    st1, st8 = encoder_init(cfg, S, "cpu"), sharded_encoder_init(cfg, S, mesh)
    step = make_sharded_encode_step(cfg, NBYTES, mesh)
    for t in range(2):
        st1, f1 = encode_step(cfg, NBYTES, st1, _pcm(s50, t))
        st8, f8 = step(st8, shard_streams(mesh, _pcm(s50, t)))
        assert_trees_equal(f8.gather(), f1)
        _golden_bytes(s50, f8.gather(), t)
    assert_trees_equal(st8.gather(), st1)


def test_sharded_decode_frames(s50):
    from lc3jax_torch.coding.host_parse import HostParser
    from lc3jax_torch.dsp.decoder import ParsedFrames, decoder_init
    from lc3jax_torch.dsp.streaming import decode_frames
    from lc3jax_torch.parallel import make_sharded_decode_frames, sharded_decoder_init

    cfg, mesh = _cfg(), _mesh()
    parser = HostParser(cfg)
    per = []
    for t in range(T):
        parser.parse(_payloads(s50, t))
        per.append(parser.upload())
    frames = ParsedFrames(**{f.name: torch.stack([getattr(p, f.name) for p in per])
                             for f in dataclasses.fields(ParsedFrames)})
    st1, pcm1 = decode_frames(cfg, NBYTES * 8, decoder_init(cfg, S, "cpu"), frames)
    run = make_sharded_decode_frames(cfg, NBYTES * 8, mesh)
    st8, pcm8 = run(sharded_decoder_init(cfg, S, mesh), frames)
    assert pcm8.axis == 1 and pcm8.shards[0].shape == (T, 2, cfg.nf)
    assert torch.equal(pcm8.gather(), pcm1)
    assert_trees_equal(st8.gather(), st1)


def test_sharded_encode_frames(s50):
    from lc3jax_torch.dsp.encoder import encoder_init
    from lc3jax_torch.dsp.streaming import encode_frames
    from lc3jax_torch.parallel import make_sharded_encode_frames, sharded_encoder_init

    cfg, mesh = _cfg(), _mesh()
    pcm = torch.stack([_pcm(s50, t) for t in range(T)])  # [T, S, nf]
    st1, f1 = encode_frames(cfg, NBYTES, encoder_init(cfg, S, "cpu"), pcm)
    run = make_sharded_encode_frames(cfg, NBYTES, mesh)
    st8, f8 = run(sharded_encoder_init(cfg, S, mesh), pcm)
    got = f8.gather()
    assert_trees_equal(got, f1)
    assert_trees_equal(st8.gather(), st1)
    for t in range(T):
        _golden_bytes(s50, {k: v[t] if isinstance(v, torch.Tensor) else v
                            for k, v in got.items()}, t)


def test_sharded_fused_decode_bytes_step(s50):
    """Bytes to PCM with the plain parse; the payloads sharded from numpy,
    the second batch on a mesh of 2, which the step reshards onto its own."""
    from lc3jax_torch.coding.device import decode_bytes_step
    from lc3jax_torch.dsp.decoder import decoder_init
    from lc3jax_torch.parallel import (make_sharded_decode_bytes_step, shard_streams,
                                       sharded_decoder_init)

    cfg, mesh = _cfg(), _mesh()
    st1, st8 = decoder_init(cfg, S, "cpu"), sharded_decoder_init(cfg, S, mesh)
    step = make_sharded_decode_bytes_step(cfg, NBYTES, mesh)
    for t in range(2):
        st1, pcm1 = decode_bytes_step(cfg, NBYTES, st1, torch.as_tensor(_payloads(s50, t)))
        st8, pcm8 = step(st8, shard_streams(mesh if t == 0 else _mesh(2), _payloads(s50, t)))
        assert pcm8.mesh == mesh and torch.equal(pcm8.gather(), pcm1)
    assert_trees_equal(st8.gather(), st1)


def test_sharded_fused_encode_bytes_step(s50):
    """PCM to bytes with the plain pack: equal to the unsharded step and to
    the oracle's frames."""
    from lc3jax_torch.coding.device import encode_bytes_step
    from lc3jax_torch.dsp.encoder import encoder_init
    from lc3jax_torch.parallel import make_sharded_encode_bytes_step, sharded_encoder_init

    cfg, mesh = _cfg(), _mesh()
    st1, st8 = encoder_init(cfg, S, "cpu"), sharded_encoder_init(cfg, S, mesh)
    step = make_sharded_encode_bytes_step(cfg, NBYTES, mesh)
    for t in range(2):
        st1, b1 = encode_bytes_step(cfg, NBYTES, st1, _pcm(s50, t))
        st8, b8 = step(st8, _pcm(s50, t))
        assert torch.equal(b8.gather(), b1)
        assert np.array_equal(b1.numpy()[OFFSETS == 0], np.tile(s50["payloads"][t], (S // 4, 1)))
    assert_trees_equal(st8.gather(), st1)


def test_multihost_helpers_single_process():
    """With no process group, multihost_stream_mesh is rank 0 of 1 over the
    given devices and multihost_shard_streams lands data as shard_streams."""
    from lc3jax_torch.parallel import (multihost_shard_streams, multihost_stream_mesh,
                                       shard_streams)

    mesh = multihost_stream_mesh(["cpu"] * 8)
    assert (mesh.size, mesh.rank, mesh.world) == (8, 0, 1)
    x = np.arange(mesh.size * 4, dtype=np.float32).reshape(-1, 4)
    got = multihost_shard_streams(mesh, x)
    assert all(torch.equal(a, b) for a, b in zip(got.shards, shard_streams(mesh, x).shards))
    np.testing.assert_array_equal(got.gather().numpy(), x)


def test_init_multihost_without_an_address_raises(monkeypatch):
    """Without arguments the process group's address, size and rank come
    from torchrun's environment; with neither, it raises and joins nothing."""
    import torch.distributed as dist

    from lc3jax_torch.parallel import init_multihost

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match=r"\$MASTER_ADDR"):
        init_multihost()
    with pytest.raises(ValueError, match=r"\$WORLD_SIZE"):
        init_multihost("127.0.0.1:1")
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_decode(tmp_path):
    """Two processes joined by gloo on 127.0.0.1, each decoding its 8 of 16
    streams over 4 CPU shards (16 kHz / 10 ms / 40 B, the payloads of
    tests/multihost_worker.py): the halves, concatenated, equal the
    one-process decode."""
    from multihost_worker import NBYTES as NB40
    from multihost_worker import build_payloads

    from lc3jax_torch.coding.device import decode_bytes_step
    from lc3jax_torch.dsp.decoder import decoder_init

    payloads = np.frombuffer(b"".join(build_payloads()), np.uint8).reshape(-1, NB40).copy()
    src = tmp_path / "payloads.npz"
    np.savez(src, payloads=payloads)
    addr = f"127.0.0.1:{_free_port()}"
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, addr, str(r), str(src), str(outs[r])],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:  # a rank whose peer died waits in the rendezvous: never leak it
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    got = np.concatenate([np.load(o)["pcm"] for o in outs])
    cfg = _cfg(16000)
    _, want = decode_bytes_step(cfg, NB40, decoder_init(cfg, len(payloads), "cpu"),
                                torch.as_tensor(payloads))
    assert torch.equal(torch.as_tensor(got), want)


def _worker(addr: str, rank: int, src: str, out: str) -> None:
    """One rank of test_two_process_sharded_decode."""
    import torch.distributed as dist

    from lc3jax_torch.parallel import (init_multihost, make_sharded_decode_bytes_step,
                                       multihost_shard_streams, multihost_stream_mesh,
                                       sharded_decoder_init)

    init_multihost(addr, num_processes=2, process_id=rank, backend="gloo")
    mesh = multihost_stream_mesh(["cpu"] * 4)
    assert (mesh.rank, mesh.world, mesh.size) == (rank, 2, 4), mesh
    payloads = np.load(src)["payloads"]
    s_local = len(payloads) // mesh.world
    local = payloads[rank * s_local : (rank + 1) * s_local]
    cfg = _cfg(16000)
    step = make_sharded_decode_bytes_step(cfg, payloads.shape[1], mesh)
    _, pcm = step(sharded_decoder_init(cfg, s_local, mesh), multihost_shard_streams(mesh, local))
    np.savez(out, pcm=pcm.gather().numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
