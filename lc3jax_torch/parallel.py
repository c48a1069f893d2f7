"""Scale-out: shard the stream axis over devices and processes (port of
lc3jax/parallel.py).

LC3 has no cross-stream coupling, so scale-out is pure data parallelism: a
1-D mesh of devices, every batched tensor split on its stream axis into
equal contiguous chunks, chunk i on device i (the row order of JAX's
`NamedSharding`: device i holds rows i*S/n .. (i+1)*S/n). Each sharded step
runs the port's own step once per shard, on that shard's device; no
operation crosses shards, just as JAX's program has no collective.

- `stream_mesh(devices)` is a `StreamMesh`: the devices in order, plus this
  process's `rank` and the `world` of processes (0 and 1 in one process).
  The default is every visible card. Unlike a JAX mesh, devices may repeat:
  PyTorch has one CPU device where JAX's tests get 8 virtual ones, so
  `stream_mesh(["cpu"] * 8)` splits a batch in 8 on the CPU, and
  `["cuda:0", "cuda:0"]` runs a real two-way split on one card.
- `shard_streams(mesh, tree, axis)` returns a `Sharded`: the per-shard
  trees, the mesh and the axis; `Sharded.gather(device)` gives back the
  whole tree (the counterpart of `np.asarray` on a global JAX array). A
  tree is a `DecoderState`, `EncoderState`, `ParsedFrames`, a field dict,
  a tensor or a numpy array. Leaves are placed by name, following JAX's
  leaf rules: `quant_pack_tables` / `pack_tables` ([rows, S]) carry the
  streams on the axis after `axis`; rank-0 leaves and Python scalars
  (`nbits_bw`, `rate_flag`, `lpc_weighting`) are the same on every shard
  and come back once. A stream count that does not split evenly raises
  ValueError, as `jax.device_put` does.
- `make_sharded_*` return `step(state, inputs) -> (state, outputs)`, each a
  `Sharded`. Inputs not yet sharded on the mesh are sharded first (JAX's
  `in_shardings`). Each shard runs its own compiled step
  (`compiled.CompiledStep`, one CUDA graph per shard and shapes, on the
  shard's device), whose static state is the shard of the state returned.
  The state passed in is donated (JAX's `donate_argnums`): its shards are
  dropped, and using it again raises.
- Each op of a shard's step follows its tensors to the shard's device, and
  `_build.launch` makes that card current around each kernel, so nothing
  here enters a device context.

Processes: `init_multihost` joins a `torch.distributed` process group (the
arguments, or the `torchrun` environment); `multihost_stream_mesh` holds
this process's own devices with its rank and world, and
`multihost_shard_streams` shards the process's own [S_local, ...] slab over
them. Nothing on the step path calls a collective: the group only starts
the processes together.

One Python thread feeding N cards launches every shard's graph replay in
turn; the scale-out that keeps a host thread per card is one process per
card: `torchrun --nproc-per-node N` with `init_multihost()` and
`multihost_stream_mesh()` in each process.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import torch

from .compiled import CompiledStep, leaves
from .config import Lc3Config
from .devices import resolve_device
from .dsp.decoder import decode_step, decoder_init
from .dsp.encoder import encode_step, encoder_init
from .dsp.streaming import decode_frames, encode_frames

# stream-minor leaves: the range coder's operand rows [rows, S]
_STREAM_MINOR = frozenset({"quant_pack_tables", "pack_tables"})


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """A 1-D mesh over the stream axis: `devices` in order (an explicit
    index on each card), this process's `rank` and the `world` size."""

    devices: tuple[torch.device, ...]
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)


def _mesh_device(device) -> torch.device:
    """torch.device(device) with an explicit card index: the port's table
    caches are keyed by torch.device, and "cuda" and "cuda:0" are two keys."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stream_mesh(devices=None) -> StreamMesh:
    """A mesh over `devices` (default: every visible card; without a card
    it raises, as every entry point does). Devices may repeat."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_mesh_device(d) for d in devices)
    if not devs:
        raise ValueError("a stream mesh needs at least one device")
    return StreamMesh(devs)


def tree_leaves(tree) -> list:
    """Every leaf of a tree (dataclasses, dicts, lists, tuples, Sharded),
    depth first."""
    return [x for leaf in leaves(tree)
            for x in (tree_leaves(leaf.shards) if isinstance(leaf, Sharded) else [leaf])]


def _place(chunk: torch.Tensor, device: torch.device) -> torch.Tensor:
    if chunk.device == device:
        return chunk
    if device.type == "cuda" and chunk.device.type == "cpu":
        # pinned and without a sync, as serving.py copies to the card
        return chunk.contiguous().pin_memory().to(device, non_blocking=True)
    return chunk.to(device)


def _split(tree, devices, axis: int, name=None) -> list:
    """`tree` cut into len(devices) trees, piece i on devices[i]."""
    n = len(devices)
    if dataclasses.is_dataclass(tree):
        parts = {f.name: _split(getattr(tree, f.name), devices, axis, f.name)
                 for f in dataclasses.fields(tree)}
        return [dataclasses.replace(tree, **{k: v[i] for k, v in parts.items()})
                for i in range(n)]
    if isinstance(tree, dict):
        parts = {k: _split(v, devices, axis, k) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if not isinstance(tree, torch.Tensor):
        return [tree] * n  # a Python scalar: the same on every shard
    if tree.ndim == 0:
        return [_place(tree, d) for d in devices]
    ax = axis + 1 if name in _STREAM_MINOR else axis
    S = tree.shape[ax]
    if S % n:
        raise ValueError(f"{name or 'leaf'}: {S} streams on axis {ax} do not split evenly "
                         f"over {n} devices")
    k = S // n
    return [_place(tree.narrow(ax, i * k, k), d) for i, d in enumerate(devices)]


def _join(shards: list, axis: int, device: torch.device, name=None):
    """The inverse of _split: the shards' pieces concatenated on `device`."""
    first = shards[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _join([getattr(s, f.name) for s in shards], axis, device, f.name)
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _join([s[k] for s in shards], axis, device, k) for k in first}
    if not isinstance(first, torch.Tensor):
        return first
    if first.ndim == 0:
        return first.to(device)
    ax = axis + 1 if name in _STREAM_MINOR else axis
    return torch.cat([s.to(device) for s in shards], dim=ax)


class Sharded:
    """A tree split over a mesh's devices on one stream axis: `shards[i]`
    lives on `mesh.devices[i]`."""

    def __init__(self, shards, mesh: StreamMesh, axis: int):
        self._shards = tuple(shards)
        self.mesh = mesh
        self.axis = axis

    @property
    def shards(self) -> tuple:
        if self._shards is None:
            raise RuntimeError("this state was donated to a sharded step; use the state the "
                               "step returned")
        return self._shards

    def gather(self, device="cpu"):
        """The whole tree on `device`, the shards concatenated in mesh order."""
        return _join(list(self.shards), self.axis, torch.device(device))

    def _donate(self) -> None:
        self._shards = None


def shard_streams(mesh: StreamMesh, tree, axis: int = 0) -> Sharded:
    """Split every leaf of `tree` on its stream axis over the mesh."""
    return Sharded(_split(tree, mesh.devices, axis), mesh, axis)


def _on_mesh(mesh: StreamMesh, tree, axis: int) -> Sharded:
    """`tree` sharded on `mesh` at `axis`, resharded if it is not yet."""
    if isinstance(tree, Sharded):
        if tree.mesh == mesh and tree.axis == axis:
            return tree
        tree = tree.gather(tree.mesh.devices[0])
    return shard_streams(mesh, tree, axis)


def _sharded_step(mesh: StreamMesh, fn, key, in_axis: int = 0, out_axis: int = 0):
    """`fn(state, x) -> (state, out)` compiled once per shard of the mesh,
    on the shard's device, and run once per shard."""
    steps = [CompiledStep(fn, key, d) for d in mesh.devices]

    def run(state, inputs):
        state = _on_mesh(mesh, state, 0)
        inputs = _on_mesh(mesh, inputs, in_axis)
        outs = [step(s, x) for step, s, x in zip(steps, state.shards, inputs.shards)]
        state._donate()
        return (Sharded([o[0] for o in outs], mesh, 0),
                Sharded([o[1] for o in outs], mesh, out_axis))

    run.steps = steps
    return run


def make_sharded_decode_step(cfg: Lc3Config, nbits: int, mesh: StreamMesh):
    """Sharded `dsp.decoder.decode_step`: ParsedFrames [S, ...] -> PCM
    int16 [S, nf]."""
    return _sharded_step(mesh, partial(decode_step, cfg, nbits), ("decode_step", cfg, nbits))


def make_sharded_encode_step(cfg: Lc3Config, nbytes: int, mesh: StreamMesh):
    """Sharded `dsp.encoder.encode_step`: int16 PCM [S, nf] -> the field dict."""
    return _sharded_step(mesh, partial(encode_step, cfg, nbytes), ("encode_step", cfg, nbytes))


def make_sharded_decode_frames(cfg: Lc3Config, nbits: int, mesh: StreamMesh):
    """Sharded frame-axis loop: ParsedFrames [T, S, ...] -> PCM [T, S, nf],
    the streams on axis 1."""
    return _sharded_step(mesh, partial(decode_frames, cfg, nbits),
                         ("decode_frames", cfg, nbits), 1, 1)


def make_sharded_encode_frames(cfg: Lc3Config, nbytes: int, mesh: StreamMesh):
    """Sharded frame-axis loop: PCM [T, S, nf] -> fields [T, S, ...]."""
    return _sharded_step(mesh, partial(encode_frames, cfg, nbytes),
                         ("encode_frames", cfg, nbytes), 1, 1)


def make_sharded_decode_bytes_step(cfg: Lc3Config, nbytes: int, mesh: StreamMesh):
    """Sharded fused decode: raw frame bytes uint8 [S, nbytes] -> PCM, the
    parse kernel and the DSP on each shard's device (the serving shape)."""
    from .coding.device import decode_bytes_step

    return _sharded_step(mesh, partial(decode_bytes_step, cfg, nbytes),
                         ("decode_bytes_step", cfg, nbytes))


def make_sharded_encode_bytes_step(cfg: Lc3Config, nbytes: int, mesh: StreamMesh):
    """Sharded fused encode: PCM [S, nf] -> frame bytes uint8 [S, nbytes],
    the DSP and the pack kernel on each shard's device. The pack kernel takes
    any number of streams, so a shard may hold any count."""
    from .coding.device import encode_bytes_step

    return _sharded_step(mesh, partial(encode_bytes_step, cfg, nbytes),
                         ("encode_bytes_step", cfg, nbytes))


def _sharded_init(init, cfg: Lc3Config, n_streams: int, mesh: StreamMesh) -> Sharded:
    if n_streams % mesh.size:
        raise ValueError(f"{n_streams} streams do not split evenly over {mesh.size} devices")
    return Sharded([init(cfg, n_streams // mesh.size, d) for d in mesh.devices], mesh, 0)


def sharded_decoder_init(cfg: Lc3Config, n_streams: int, mesh: StreamMesh) -> Sharded:
    """A fresh DecoderState for `n_streams` (this process's streams), built
    on each shard's device."""
    return _sharded_init(decoder_init, cfg, n_streams, mesh)


def sharded_encoder_init(cfg: Lc3Config, n_streams: int, mesh: StreamMesh) -> Sharded:
    """A fresh EncoderState for `n_streams`, built on each shard's device."""
    return _sharded_init(encoder_init, cfg, n_streams, mesh)


# ------------------------------------------------------------ processes


def _env(name: str) -> str:
    if name not in os.environ:
        raise ValueError(f"init_multihost: pass the argument or set ${name} (torchrun sets it)")
    return os.environ[name]


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, backend: str | None = None) -> None:
    """Join the process group of a multi-process run: one process per card,
    each feeding its own streams.

    coordinator_address is "host:port" of rank 0 (default
    $MASTER_ADDR:$MASTER_PORT), num_processes the world size (default
    $WORLD_SIZE), process_id this process's rank (default $RANK): `torchrun`
    sets all four. The backend is nccl where the process has a card, gloo
    otherwise; pass gloo to put two processes on one card (NCCL refuses
    two ranks on one device). Call once per process, before any other use."""
    import torch.distributed as dist

    if coordinator_address is None:
        coordinator_address = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT')}"
    world = num_processes if num_processes is not None else int(_env("WORLD_SIZE"))
    rank = process_id if process_id is not None else int(_env("RANK"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def multihost_stream_mesh(devices=None) -> StreamMesh:
    """A mesh over this process's own devices (default: cuda:$LOCAL_RANK),
    with its rank and the world size from torch.distributed (0 and 1 where
    no group was joined)."""
    import torch.distributed as dist

    if devices is None:
        devices = [f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"]
    mesh = stream_mesh(devices)
    if dist.is_available() and dist.is_initialized():
        mesh = dataclasses.replace(mesh, rank=dist.get_rank(), world=dist.get_world_size())
    return mesh


def multihost_shard_streams(mesh: StreamMesh, local_tree, axis: int = 0) -> Sharded:
    """Shard this process's [S_local, ...] slab over its own devices; the
    process of rank r holds global rows r*S_local .. (r+1)*S_local. With one
    process this is shard_streams."""
    return shard_streams(mesh, local_tree, axis)
