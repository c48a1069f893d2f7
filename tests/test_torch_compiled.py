"""lc3jax_torch.compiled on the CPU: the copy-in / copy-out plumbing of the
compiled steps (`make_decode_step`, `make_encode_step`, the serving step
caches, the chunked frame loop) held `torch.equal` to the eager step
functions, outputs and state after every frame, over the rate plan of
tests/goldens/torch_config_parity.npz (80 -> 150 -> 40 B at 48 kHz / 10 ms,
the encode byte-exact to the oracle's frames); donation; checkpoints; and
the property a CUDA graph capture needs: the steps' glue reads no tensor
value on the host outside the kernels' plain versions. The capture itself
runs only on a card (chip_smoke.py phase 11)."""

import contextlib
import copy
import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lc3jax_torch.checkpoint import load_state, save_state
from lc3jax_torch.coding import host_pack
from lc3jax_torch.coding.device import (decode_bytes_step, decode_bytes_step_stats,
                                        encode_bytes_step, make_decode_bytes_step)
from lc3jax_torch.coding.host_parse import HostParser
from lc3jax_torch.compiled import CompiledStep, leaves
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import encoder_fields_to_numpy
from lc3jax_torch.dsp.decoder import decode_step, decoder_init, make_decode_step
from lc3jax_torch.dsp.encoder import encode_step, encoder_init, make_encode_step
from lc3jax_torch.dsp.streaming import decode_bytes_frames
from lc3jax_torch.serving import BatchDecoder, BatchEncoder

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
S, NFRAMES = 2, 6  # the rate plan's first six frames: 80, 80, 150, 150, 40, 40 B


@pytest.fixture(scope="module")
def plan(goldens):
    """Per frame: nbytes, payloads uint8 [S, nbytes] (stream 1: stream 0's
    frame with three bytes overwritten), PCM int16 [S, nf] (stream 1: the
    frame before), the oracle's frame of stream 0."""
    cp = goldens("torch_config_parity")
    nbs = [int(n) for n in cp["rate_plan_nbytes"][:NFRAMES]]
    assert nbs == [80, 80, 150, 150, 40, 40]
    rng = np.random.default_rng(7)
    out = []
    for f, nb in enumerate(nbs):
        frame = cp["rate_plan_payloads"][f, :nb]
        bad = frame.copy()
        bad[rng.integers(0, nb, 3)] = rng.integers(0, 256, 3)
        pcm = cp["rate_plan_pcm_in"]
        prev = pcm[f - 1] if f else np.zeros_like(pcm[0])
        out.append((nb, np.stack([frame, bad]), np.stack([pcm[f], prev]), frame))
    return out


def assert_same(a, b, what) -> None:
    """Trees equal leaf by leaf: tensors torch.equal (dtype and shape
    included), other leaves ==."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), (what, i)
        else:
            assert x == y, (what, i)


def _parsed(nb, payloads):
    parser = HostParser(CFG48, "cpu")
    parser.parse(payloads)
    return parser.upload()


def test_make_steps_equal_the_eager_steps(plan):
    """make_decode_step / make_encode_step, one per frame size as lc3jax
    jits one per size, the state handed from one to the next: PCM, fields
    and state equal the eager steps' after every frame; the encode packs to
    the oracle's frames."""
    dec_steps = {nb: make_decode_step(CFG48, nb * 8, "cpu") for nb, *_ in plan}
    enc_steps = {nb: make_encode_step(CFG48, nb, "cpu") for nb, *_ in plan}
    dc = de = decoder_init(CFG48, S, "cpu")
    ec = ee = encoder_init(CFG48, S, "cpu")
    for f, (nb, payloads, pcm, oracle) in enumerate(plan):
        frames = _parsed(nb, payloads)
        dc, pcm_c = dec_steps[nb](dc, frames)
        de, pcm_e = decode_step(CFG48, nb * 8, de, frames)
        assert_same((dc, pcm_c), (de, pcm_e), f"decode frame {f}")
        x = torch.as_tensor(pcm)
        ec, fields_c = enc_steps[nb](ec, x)
        ee, fields_e = encode_step(CFG48, nb, ee, x)
        assert_same((ec, fields_c), (ee, fields_e), f"encode frame {f}")
        packed = host_pack.pack_frames(CFG48, encoder_fields_to_numpy(fields_c), nb)
        assert np.array_equal(packed[0], oracle), f
    assert {s.captures for s in (*dec_steps.values(), *enc_steps.values())} == {0}


@pytest.mark.parametrize("path", ["make_decode_step", "make_encode_step", "sharded"])
def test_steps_of_each_frame_size_hand_the_state_back_and_forth(plan, path):
    """One step a frame size, the stream going 80 -> 150 -> 80 -> 150 -> 80
    -> 150 B (five switches): each step copies in the state the other
    returned, which frees the other's slot and is donated, so no switch
    raises; outputs and state equal the eager step's after every frame;
    each step (each shard's) keeps one static state and one graph."""
    from lc3jax_torch import parallel

    frames = [plan[0], plan[2], plan[1], plan[3], plan[0], plan[2]]
    sizes = (80, 150)
    if path == "make_decode_step":
        steps = {nb: make_decode_step(CFG48, nb * 8, "cpu") for nb in sizes}
        eager = lambda st, nb, p, x: decode_step(CFG48, nb * 8, st, _parsed(nb, p))
        run = lambda st, nb, p, x: steps[nb](st, _parsed(nb, p))
        got = want = decoder_init(CFG48, S, "cpu")
    elif path == "make_encode_step":
        steps = {nb: make_encode_step(CFG48, nb, "cpu") for nb in sizes}
        eager = lambda st, nb, p, x: encode_step(CFG48, nb, st, torch.as_tensor(x))
        run = lambda st, nb, p, x: steps[nb](st, torch.as_tensor(x))
        got = want = encoder_init(CFG48, S, "cpu")
    else:
        mesh = parallel.stream_mesh(["cpu"] * S)
        steps = {nb: parallel.make_sharded_decode_bytes_step(CFG48, nb, mesh) for nb in sizes}
        eager = lambda st, nb, p, x: decode_bytes_step(CFG48, nb, st, torch.as_tensor(p))
        run = lambda st, nb, p, x: steps[nb](st, parallel.shard_streams(mesh, p))
        got, want = parallel.sharded_decoder_init(CFG48, S, mesh), decoder_init(CFG48, S, "cpu")
    read = lambda t: t.gather() if isinstance(t, parallel.Sharded) else t
    for f, (nb, payloads, pcm, _) in enumerate(frames):
        got, out = run(got, nb, payloads, pcm)
        want, out_e = eager(want, nb, payloads, pcm)
        assert_same((read(got), read(out)), (want, out_e), f"{path} frame {f} ({nb} B)")
    shard_steps = lambda s: getattr(s, "steps", [s])
    made = [c for nb in sizes for c in shard_steps(steps[nb])]
    assert [(c.calls, c.captures) for c in made] == [(3, 0)] * len(made)
    assert [(len(c.cache.states), len(c.graphs)) for c in made] == [(1, 1)] * len(made)


def test_two_states_through_one_toy_step():
    """An accumulator step fed two streams' states: the first state
    returned keeps its values when the second stream runs (lc3jax's
    donation), each stream continues from its own state without a copy,
    and a donated state raises."""
    step = CompiledStep(lambda st, x: (st + x, st * 2), "toy", "cpu")
    one = torch.ones(2)
    a, b = torch.zeros(2), torch.full((2,), 100.0)
    a1, _ = step(a, one)
    b1, _ = step(b, one)
    assert a1 is not b1 and a1.tolist() == [1, 1] and b1.tolist() == [101, 101]
    a2, out_a = step(a1, one)
    b2, out_b = step(b1, one)
    assert a2 is a1 and b2 is b1 and out_a.tolist() == [2, 2] and out_b.tolist() == [202, 202]
    assert (a2.tolist(), b2.tolist(), step.state_copies) == ([2, 2], [102, 102], 2)
    with pytest.raises(RuntimeError, match="donated"):
        step(b, one)
    del a1, a2  # a state dropped frees its slot: a third stream takes it
    c1, _ = step(torch.full((2,), 7.0), one)
    assert c1.tolist() == [8, 8] and b2.tolist() == [102, 102]
    assert len(step.cache.states) == len(step.graphs) == 2


def _two_stream_path(path, nb):
    """(run(state, payloads, pcm), eager(state, payloads, pcm), init(),
    eager_init(), read, steps) for one compiled path at nb bytes."""
    from lc3jax_torch import parallel

    ident = lambda t: t
    if path == "make_decode_step":
        step = make_decode_step(CFG48, nb * 8, "cpu")
        return (lambda st, p, x: step(st, _parsed(nb, p)),
                lambda st, p, x: decode_step(CFG48, nb * 8, st, _parsed(nb, p)),
                lambda: decoder_init(CFG48, S, "cpu"), lambda: decoder_init(CFG48, S, "cpu"),
                ident, [step])
    if path == "make_encode_step":
        step = make_encode_step(CFG48, nb, "cpu")
        return (lambda st, p, x: step(st, torch.as_tensor(x)),
                lambda st, p, x: encode_step(CFG48, nb, st, torch.as_tensor(x)),
                lambda: encoder_init(CFG48, S, "cpu"), lambda: encoder_init(CFG48, S, "cpu"),
                ident, [step])
    if path == "make_decode_bytes_step":
        step = make_decode_bytes_step(CFG48, nb, "cpu")
        return (lambda st, p, x: step(st, torch.as_tensor(p)),
                lambda st, p, x: decode_bytes_step(CFG48, nb, st, torch.as_tensor(p)),
                lambda: decoder_init(CFG48, S, "cpu"), lambda: decoder_init(CFG48, S, "cpu"),
                ident, [step])
    mesh = parallel.stream_mesh(["cpu"] * int(path[-1]))
    step = parallel.make_sharded_decode_bytes_step(CFG48, nb, mesh)
    return (lambda st, p, x: step(st, parallel.shard_streams(mesh, p)),
            lambda st, p, x: decode_bytes_step(CFG48, nb, st, torch.as_tensor(p)),
            lambda: parallel.sharded_decoder_init(CFG48, S, mesh),
            lambda: decoder_init(CFG48, S, "cpu"),
            lambda t: t.gather() if isinstance(t, parallel.Sharded) else t, step.steps)


@pytest.mark.parametrize("path", ["make_decode_step", "make_encode_step",
                                  "make_decode_bytes_step", "sharded x1", "sharded x2"])
def test_two_states_through_one_step(plan, path):
    """Two streams' states fed interleaved to one compiled step (stream B:
    stream A's batches with the streams swapped and the corrupt row
    first): after every frame each stream's output and state equal its own
    eager stream's, the states are distinct objects, and after the first
    frame neither stream's state is copied in again."""
    nb = 150
    batches = [(p, x) for n, p, x, _ in plan if n == nb] * 2
    run, eager, init, eager_init, read, steps = _two_stream_path(path, nb)
    got = {"a": init(), "b": init()}
    want = {"a": eager_init(), "b": eager_init()}
    for f, (payloads, pcm) in enumerate(batches):
        for k in ("a", "b"):
            p, x = (payloads, pcm) if k == "a" else (payloads[::-1].copy(), pcm[::-1].copy())
            got[k], out = run(got[k], p, x)
            want[k], out_e = eager(want[k], p, x)
            assert_same((read(got[k]), read(out)), (want[k], out_e), f"{path} {k} frame {f}")
        assert got["a"] is not got["b"]
    assert not torch.equal(leaves(read(got["a"]))[0], leaves(read(got["b"]))[0])
    assert [(s.calls, s.state_copies, len(s.cache.states)) for s in steps] == (
        [(2 * len(batches), 2, 2)] * len(steps))


def _decode_path(path, plan):
    """(outputs, state) of each frame through one serving decode path."""
    if path == "decode_tensor":
        dec = BatchDecoder(CFG48, S, plan[0][0], device="cpu")
        return [(dec.decode_tensor(torch.as_tensor(p)), copy.deepcopy(dec.state))
                for _, p, _, _ in plan], dec
    if path == "host_parse":
        dec = BatchDecoder(CFG48, S, plan[0][0], device="cpu", device_parse=False)
        return [(torch.as_tensor(dec.decode(p)), copy.deepcopy(dec.state))
                for _, p, _, _ in plan], dec
    dec = BatchDecoder(CFG48, S, plan[0][0], device="cpu")  # chunks of 2: one per frame size
    pcm = dec.decode_stream([p for _, p, _, _ in plan], fetch=False, chunk_frames=2)
    return [(x, None) for x in pcm], dec


@pytest.mark.parametrize("path", ["decode_tensor", "host_parse", "chunk_frames"])
def test_serving_decode_equals_the_eager_step(plan, path):
    """Each compiled decode path over the frame-size changes and the
    corrupt stream: PCM (and state, where read per frame) equal to the
    eager decode_bytes_step_stats; one step per frame size."""
    got, dec = _decode_path(path, plan)
    st = decoder_init(CFG48, S, "cpu")
    for f, ((pcm, state), (nb, payloads, _, _)) in enumerate(zip(got, plan)):
        st, want, _ = decode_bytes_step_stats(CFG48, nb, st, torch.as_tensor(payloads))
        assert torch.equal(pcm, want), (path, f)
        if state is not None:
            assert_same(state, st, f"{path} state frame {f}")
    assert_same(dec.state, st, f"{path} final state")
    kind = {"decode_tensor": "stats", "host_parse": "parsed", "chunk_frames": "chunk"}[path]
    assert [k for k in dec.steps] == [(kind, nb, 2 if kind == "chunk" else 0)
                                      for nb in (80, 150, 40)]


@pytest.mark.parametrize("fused", [False, True])
def test_serving_encode_equals_the_eager_step(plan, fused):
    """BatchEncoder's fields step and fused step over the frame-size
    changes: fields or bytes and state equal the eager step's after every
    frame, stream 0 byte-exact to the oracle's frames (the state carried
    across nbytes switches)."""
    enc = BatchEncoder(CFG48, S, plan[0][0], device="cpu", device_pack=fused)
    st = encoder_init(CFG48, S, "cpu")
    for f, (nb, _, pcm, oracle) in enumerate(plan):
        x = torch.as_tensor(pcm)
        if fused:
            got = enc.encode_tensor(x, nb)
            st, want = encode_bytes_step(CFG48, nb, st, x)
            assert np.array_equal(got[0].numpy(), oracle), f
        else:
            got = enc.encode_fields_tensor(x, nb)
            st, want = encode_step(CFG48, nb, st, x)
            packed = host_pack.pack_frames(CFG48, encoder_fields_to_numpy(got), nb)
            assert np.array_equal(packed[0], oracle), f
        assert_same(got, want, f"frame {f}")
        assert_same(enc.state, st, f"state frame {f}")
    assert list(enc.steps) == [("bytes" if fused else "fields", nb) for nb in (80, 150, 40)]


def test_results_are_distinct_tensors(plan):
    """Successive decode_tensor results and decode_stream(fetch=False)
    entries are tensors of their own that keep their values."""
    nb = plan[2][0]
    batches = [plan[2][1], plan[3][1]]
    dec = BatchDecoder(CFG48, S, nb, device="cpu")
    outs = [dec.decode_tensor(torch.as_tensor(b)) for b in batches]
    kept = [o.clone() for o in outs]
    streamed = BatchDecoder(CFG48, S, nb, device="cpu").decode_stream(batches, fetch=False)
    for group in (outs, streamed):
        assert len({o.data_ptr() for o in group}) == len(group)
    assert all(torch.equal(a, b) for a, b in zip(outs, kept))
    assert all(torch.equal(a, b) for a, b in zip(streamed, kept))


def test_state_is_donated(plan):
    """A state passed back in is the step's own and is not copied; a state
    of one's own is copied once, and passing it again raises."""
    nb, payloads = plan[2][0], plan[2][1]
    frames = _parsed(nb, payloads)
    step = make_decode_step(CFG48, nb * 8, "cpu")
    mine = decoder_init(CFG48, S, "cpu")
    st, _ = step(mine, frames)
    ptrs = [t.data_ptr() for t in leaves(st)]
    st2, _ = step(st, frames)
    assert st2 is st and [t.data_ptr() for t in leaves(st2)] == ptrs
    assert step.state_copies == 1 and step.calls == 2
    with pytest.raises(RuntimeError, match="donated"):
        step(mine, frames)
    assert isinstance(step, CompiledStep) and step.key == ("decode_step", CFG48, nb * 8)


@pytest.mark.parametrize("kind", ["decoder", "encoder"])
def test_checkpoint_resumes_into_the_live_state(plan, kind, tmp_path):
    """`coder.state = load_state(path, coder.state)` copies the checkpoint
    into the coder's own state and resumes bit-exact."""
    def coder():
        if kind == "decoder":
            return BatchDecoder(CFG48, S, plan[0][0], device="cpu")
        return BatchEncoder(CFG48, S, plan[0][0], device="cpu", device_pack=True)

    def step(c, f):
        nb, payloads, pcm, _ = plan[f]
        return c.decode(payloads) if kind == "decoder" else c.encode(pcm, nb)

    live = coder()
    for f in range(3):
        step(live, f)
    path = str(tmp_path / "state.npz")
    save_state(path, live.state)
    want = [step(live, f) for f in range(3, NFRAMES)]
    resumed = coder()
    own = resumed.state
    resumed.state = load_state(path, resumed.state)
    assert resumed.state is own
    assert all(np.array_equal(step(resumed, f), w) for f, w in zip(range(3, NFRAMES), want))


# the kernels' plain versions: the CPU path of each wrapper, never run on a card
PLAIN = frozenset({"device_parse_plain", "tns_synthesis_plain", "ltpf_both_passes_plain",
                   "sns_pvq_plain", "tns_autocorr_plain", "tns_coefficients_plain",
                   "tns_analysis_plain",
                   "bitmodel_table_part_plain", "device_pack_plain"})
HOST_READS = frozenset({"aten._local_scalar_dense.default", "aten.nonzero.default",
                        "aten.masked_select.default", "aten._unique2.default",
                        "aten.unique_dim.default", "aten.unique_consecutive.default",
                        "aten.repeat_interleave.Tensor", "aten.repeat_interleave.self_Tensor"})


def _outside_plain() -> str | None:
    """The innermost caller's name where no frame of the stack is a plain
    version, else None."""
    frame = sys._getframe(2)
    where = f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"
    while frame is not None:
        if frame.f_code.co_name in PLAIN:
            return None
        frame = frame.f_back
    return where


class _HostReads(TorchDispatchMode):
    """Records the ops that read a tensor's values on the host (on a card:
    a sync, which breaks a capture) outside the plain versions."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in HOST_READS:
            where = _outside_plain()
            if where:
                self.found.append((str(func), where))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _host_reads(monkeypatch):
    """_HostReads, plus the reads and host-to-device tables that dispatch
    does not see: Tensor.tolist / numpy and torch.tensor / as_tensor /
    from_numpy (on a card, a table made inside a step is a pageable copy)."""
    mode = _HostReads()

    def watch(owner, name):
        real = getattr(owner, name)

        def wrapped(*a, **k):
            where = _outside_plain()
            if where:
                mode.found.append((name, where))
            return real(*a, **k)

        monkeypatch.setattr(owner, name, wrapped)

    for owner, name in ((torch.Tensor, "tolist"), (torch.Tensor, "numpy"), (torch, "tensor"),
                        (torch, "as_tensor"), (torch, "from_numpy")):
        watch(owner, name)
    with mode:
        yield mode


@pytest.mark.parametrize("step", ["encode_bytes_step", "decode_bytes_step_stats",
                                  "decode_step"])
def test_step_glue_reads_nothing_on_the_host(plan, step, monkeypatch):
    """After a first call (which fills the table caches, as the warm-up
    does before a capture), a step makes no host read of a tensor value and
    builds no tensor from host data outside the eight kernels' plain
    versions: the property a CUDA graph capture needs."""
    nb, payloads, pcm, _ = plan[2]
    pcm, payloads = torch.as_tensor(pcm), torch.as_tensor(payloads)
    if step == "encode_bytes_step":
        run = lambda: encode_bytes_step(CFG48, nb, encoder_init(CFG48, S, "cpu"), pcm)
    elif step == "decode_bytes_step_stats":
        run = lambda: decode_bytes_step_stats(CFG48, nb, decoder_init(CFG48, S, "cpu"), payloads)
    else:
        frames = _parsed(nb, payloads)
        run = lambda: decode_step(CFG48, nb * 8, decoder_init(CFG48, S, "cpu"), frames)
    want = run()
    with _host_reads(monkeypatch) as mode:
        got = run()
    assert not mode.found, mode.found
    assert_same(got, want, step)


def test_chunked_step_runs_the_frame_loop(plan, monkeypatch):
    """The chunk step on the CPU calls dsp.streaming.decode_bytes_frames
    once a chunk, through the step cache (key ("chunk", nbytes, T))."""
    calls = []

    def spy(cfg, nbytes, state, payloads):
        calls.append(tuple(payloads.shape))
        return decode_bytes_frames(cfg, nbytes, state, payloads)

    import lc3jax_torch.serving as serving

    monkeypatch.setattr(serving, "decode_bytes_frames", spy)
    dec = BatchDecoder(CFG48, S, 150, device="cpu")
    batches = [plan[2][1], plan[3][1]] * 2
    dec.decode_stream(batches, chunk_frames=2)
    step = dec.steps[("chunk", 150, 2)]
    assert calls == [(2, S, 150)] * 2 and step.calls == 2 and len(step.graphs) == 1
    assert dataclasses.is_dataclass(step.graphs[0])
