"""Compiled steps: one CUDA graph per step and argument shapes, the port's
counterpart of the `jax.jit(partial(step, cfg, n), donate_argnums=(0,))`
that lc3jax wraps around every step it runs (`make_decode_step`,
`make_encode_step`, the serving step caches, the chunked frame scan, the
sharded steps).

A step is `fn(state, *inputs) -> (state, *outputs)` whose tensor shapes
follow from what it was built for (config, frame size) and from its
arguments' shapes. `CompiledStep(fn, key, device)` keeps one graph per set
of argument shapes. On a card, the first call with new shapes:

1. warms up: runs fn eagerly WARMUP times on the cache's capture stream,
   from copies of the state and inputs, so that every lazy table cache
   (the decoder and encoder tables, the kernels' device tables, the FFT
   twiddles, cuBLAS's workspace for that stream) is filled before the
   capture: a table built during capture would land in the graph's pool,
   and its pageable copy to the card would break the capture;
2. copies the inputs into static input buffers; the state lives in the
   cache's static state; both are allocated outside any graph pool;
3. captures fn on those buffers into one `torch.cuda.CUDAGraph`, ending in
   `copy_` of the new state into the static state (the copies come after
   every read in stream order, so the update in place is safe). The
   capture runs with `capture_error_mode="thread_local"`, so that
   `decode_stream`'s prefetch thread may go on parsing beside it, and
   under `torch.cuda.set_sync_debug_mode("error")`, so that a host read of
   a device value inside fn raises where it happens;
4. replays the graph.

Later calls copy their inputs into the static inputs and replay. An input
that already is its static buffer is not copied (`coding.host_parse`
uploads straight into them: `buffers`).

States follow lc3jax's donation: the state a step returns belongs to its
caller until the caller passes it into a step again. Passed back to a step
of the same cache, it is used in place (no copy) and returned again. Any
other state is copied into one of the cache's static state slots and
marked donated, so that passing it to a compiled step again raises. A slot
is free once its caller no longer holds the state it was returned as: that
state was dropped, or passed into a step of another cache. A foreign state
takes a free slot of its shapes, or a new slot where every one is held,
and each slot has graphs of its own (keyed by argument shapes and slot).
So two streams through one step stay independent, each on its own static
buffers, and a stream handed back and forth between the steps of several
caches (one step a frame size, as lc3jax jits one a size) reuses the slot
it left: the slots and graphs do not grow with the switches. A coder's own
state (`StepCache(device, state)`, the serving coders') is pinned: it is
its cache's one slot, never free, and passing it to another cache's step
copies it without marking it donated. A warm-up, capture or replay that
fails raises; nothing runs the step eagerly in its place.

Outputs: `__call__` clones each tensor output once after the replay, so
that successive results are distinct tensors that keep their values;
`run` returns the graph's own output buffers, valid until the next call of
a step of the same cache, for a caller that fetches them to the host at
once. The returned state is a view of its slot's static buffers: the next
call with it updates it in place.

All steps of one `StepCache` (one coder) share its slots, so a stream's
state carries across a change of frame size as it does in eager code, and
one graph memory pool: their outputs are cloned
or fetched before the next replay, and replays are queued in order on one
stream, so no graph reads what another wrote.

On the CPU, which only a caller asking for it reaches, the same copy-in and
copy-out plumbing runs with an eager call of fn in place of the replay.

Spans (`metrics.py`), into the cache's recorder (a serving coder's
`metrics`), under the call's root span where one is open: `step.copy_in`
(the inputs copied into the static inputs), `step.replay` (the replay and
the launch counts; on the CPU, the eager call), with the replay's time on
the card on one call in `metrics.EDGE_EVERY`; and at a graph's first call
the set-up span `step.capture` (its `capture_ms`), keyed by the step's
key, with children `step.warmup`, `step.graph` and `step.instantiate`.

Launch counters: `_build.launch` counts each kernel launch in
`_build.launches`, and a replay calls no wrapper. So each graph records
the counts its capture made and adds them again on every replay; the
warm-up's and the capture's own launches are not counted. These are
capture records: that a replay launches what its capture recorded is what
chip_smoke.py phase 11 holds against the profiler.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref

import torch

from . import _build
from .devices import resolve_device
from .metrics import CodecMetrics, Span

WARMUP = 2  # eager runs on the capture stream before a capture

# ------------------------------------------------------------------ trees


def leaves(tree) -> list:
    """The leaves of a tree of dataclasses, dicts, lists and tuples, depth
    first in field order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """`tree` with fn applied to each tensor leaf; other leaves kept."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _signature(tree) -> tuple:
    """What a graph is specialised to: each leaf's shape and dtype (a
    tensor) or value (anything else)."""
    return tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else x
                 for x in leaves(tree))


def _copy_into(src_tree, dst_tree) -> None:
    """Copy each tensor leaf of src_tree into dst_tree's, where they are not
    the same tensor; non-blocking from pinned memory."""
    for s, d in zip(leaves(src_tree), leaves(dst_tree)):
        if s is not d:
            d.copy_(s, non_blocking=True)


def _store(new, static) -> None:
    """Copy the new state into the static state. A new leaf that shares
    storage with a static leaf it is not (a view of another field) is
    cloned first, so that no copy overwrites what a later one reads."""
    src, dst = leaves(new), leaves(static)
    if [_signature(s) for s in src] != [_signature(d) for d in dst]:
        raise ValueError("the step's new state differs in structure, shape or dtype from the "
                         "state it was given")
    held = {d.untyped_storage().data_ptr() for d in dst}
    src = [s.clone() if s is not d and s.untyped_storage().data_ptr() in held else s
           for s, d in zip(src, dst)]
    for s, d in zip(src, dst):
        if s is not d:
            d.copy_(s)


# the states donated to a compiled step, by id (an entry goes with its state)
_DONATED: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
# every slot, by the id of its static state and of the state it last handed
# out (an entry goes with its slot; a hit is checked against the slot)
_SLOTS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _mark(marks: weakref.WeakValueDictionary, state) -> None:
    try:
        marks[id(state)] = state
    except TypeError:  # a tuple or other tree without weak references: not marked
        pass


def _marked(marks: weakref.WeakValueDictionary, state) -> bool:
    return marks.get(id(state)) is state


class _Slot:
    """One static state of a cache: the buffers its graphs are captured
    on, and the state last handed to a caller (held weakly, so that a
    state the caller dropped frees the slot; a pinned slot's is its static
    state, held for good)."""

    def __init__(self, cache: "StepCache", index: int, static, pinned: bool = False):
        self.cache, self.index, self.static, self.pinned = cache, index, static, pinned
        self.sig = _signature(static)
        self._handed = (lambda: static) if pinned else None
        _SLOTS[id(static)] = self

    def held(self):
        """The state a caller holds for this slot, or None: the slot is free."""
        return None if self._handed is None else self._handed()

    def owns(self, state) -> bool:
        return state is self.static or state is self.held()

    def release(self) -> None:
        """The held state was passed into another cache's step: the slot is
        free (and that state donated)."""
        if not self.pinned:
            self._handed = None

    def hand(self):
        """The state to return: the one held, else a new view of the static
        buffers, which the slot then holds weakly."""
        state = self.held()
        if state is None:
            state = tree_map(torch.Tensor.detach, self.static)
            try:
                self._handed = weakref.ref(state)
            except TypeError:  # a tuple or other tree without weak references
                self._handed = lambda: state
            _SLOTS[id(state)] = self
        return state


# ------------------------------------------------------------------ steps


class StepCache:
    """One coder's compiled steps: the static state slots they share, the
    graphs' memory pool and the capture stream.

    `state` (optional) is pinned as the cache's slot for its shapes, as it
    is: a serving coder hands in its fresh `decoder_init` / `encoder_init`
    state. Any other state is copied into a free slot of its shapes, or a
    new one (see the module's docstring). `metrics` is the recorder the
    steps' spans go into (a serving coder's; one of the cache's own when
    None)."""

    def __init__(self, device, state=None, metrics: CodecMetrics | None = None):
        self.device = resolve_device(device)
        self.metrics = CodecMetrics() if metrics is None else metrics
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.on_card = self.device.type == "cuda"
        self._slots: list = []
        if state is not None:
            self._slots.append(_Slot(self, 0, state, pinned=True))
        self._steps: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self._stream = None

    def step(self, key, fn) -> "CompiledStep":
        """The cache's compiled step for `key`, made from fn at first use."""
        s = self._steps.get(key)
        if s is None:
            s = self._steps[key] = CompiledStep(fn, key, self.device, cache=self)
        return s

    @property
    def steps(self) -> dict:
        """key -> CompiledStep, in the order they were made."""
        return dict(self._steps)

    @property
    def states(self) -> list:
        """Each slot's static state, in the order the slots were made."""
        return [s.static for s in self._slots]

    @property
    def state(self):
        """The one static state (a serving coder's live state)."""
        if len(self._slots) != 1:
            raise RuntimeError(f"{len(self._slots)} static states; expected one")
        return self._slots[0].static

    @state.setter
    def state(self, value) -> None:
        static = self.state
        if _signature(value) != _signature(static):
            raise ValueError("the state assigned differs in structure, shape or dtype from "
                             "the coder's")
        _copy_into(value, static)

    def adopt(self, state) -> tuple["_Slot", bool]:
        """(the slot that runs `state`, whether it was copied in): its own
        slot where `state` is this cache's, else a free slot of its shapes
        (a new one where none is free) holding a copy of it, and `state`
        marked donated unless it is another cache's pinned or static state.
        Another cache's held state frees that cache's slot."""
        other = _SLOTS.get(id(state))
        if other is not None and not other.owns(state):
            other = None
        if other is not None and other.cache is self:
            return other, False
        if _marked(_DONATED, state):
            raise RuntimeError("this state was donated to a compiled step; use the state the "
                               "step returned")
        sig = _signature(state)
        slot = next((s for s in self._slots if s.sig == sig and s.held() is None), None)
        if slot is None:
            slot = _Slot(self, len(self._slots),
                         tree_map(lambda t: t.detach().to(self.device, copy=True), state))
            self._slots.append(slot)
        else:
            _copy_into(state, slot.static)
        if other is None or not (other.pinned or state is other.static):
            _mark(_DONATED, state)
        if other is not None:
            other.release()
        return slot, True

    def capture_stream(self):
        """The stream the cache's steps warm up and capture on, made to
        wait for the work queued so far on the device's current stream."""
        self._stream = _build.fork(self.device, self._stream)
        return self._stream


@dataclasses.dataclass
class _Graph:
    """One step's graph for one set of argument shapes (on the CPU, its
    static inputs alone)."""

    inputs: tuple  # the static input trees
    outputs: tuple | None = None  # the graph's output trees
    graph: object = None  # torch.cuda.CUDAGraph
    counts: dict = dataclasses.field(default_factory=dict)  # launches a replay
    capture: Span | None = None  # the step.capture span: warm-up, capture, instantiation

    @property
    def capture_ms(self) -> float:
        """The capture's host wall ms (0 on the CPU, where nothing is captured)."""
        return 0.0 if self.capture is None else self.capture.ms


class CompiledStep:
    """fn(state, *inputs) -> (state, *outputs) run as one CUDA graph per
    set of argument shapes on `device` (see the module's docstring), or
    eagerly through the same static buffers on the CPU.

    `key` names what fn was built for (config, frame size, ...); `cache`
    is the coder's StepCache, whose static state and pool its steps share
    (a cache of its own when None). `captures` counts the graphs captured,
    `calls` the calls, `state_copies` the states copied in."""

    def __init__(self, fn, key, device="cuda", cache: StepCache | None = None):
        self.fn = fn
        self.key = key
        self.cache = cache if cache is not None else StepCache(device)
        self._graphs: dict = {}
        self._last: _Graph | None = None
        self.captures = 0
        self.calls = 0
        self.state_copies = 0

    @property
    def graphs(self) -> list:
        """Each graph's record (static buffers, launches a replay, capture
        ms), in the order they were made."""
        return list(self._graphs.values())

    def buffers(self) -> tuple | None:
        """The static input trees of the graph last run (None before the
        first call): an input uploaded into them is not copied again."""
        return None if self._last is None else self._last.inputs

    def __call__(self, state, *inputs):
        """(state, *outputs): the static state and a clone of each output."""
        state, outs = self._run(state, inputs)
        return (state, *tree_map(torch.clone, outs))

    def run(self, state, *inputs):
        """(state, *outputs): the static state and the graph's own output
        buffers, overwritten by the next call of a step of this cache."""
        state, outs = self._run(state, inputs)
        return (state, *outs)

    def _run(self, state, inputs: tuple):
        cache = self.cache
        rec = cache.metrics
        slot, copied = cache.adopt(state)
        self.state_copies += copied
        static = slot.static
        key = (_signature(inputs), slot.index)
        g = self._graphs.get(key)
        if g is None:
            g = _Graph(tree_map(lambda t: t.detach().to(cache.device, copy=True), inputs))
            if cache.on_card:
                self._capture(g, static)
            self._graphs[key] = g
        else:
            t = time.time_ns()
            _copy_into(inputs, g.inputs)
            rec.span("step.copy_in", t)
        self._last = g
        t = time.time_ns()
        if cache.on_card:
            edge = rec.edge_start(cache.device)
            g.graph.replay()
            if edge is not None:
                edge[0][1].record()
            _build.launches.update(g.counts)
            rec.span("step.replay", t, edge)
        else:
            out = self.fn(static, *g.inputs)
            _store(out[0], static)
            g.outputs = tuple(out[1:])
            rec.span("step.replay", t)
        self.calls += 1
        return slot.hand(), g.outputs

    def _capture(self, g: _Graph, static) -> None:
        cache = self.cache
        rec = cache.metrics
        before = _build.launches.copy()
        with rec.setup("step.capture", key=self.key) as cap:
            try:
                stream = cache.capture_stream()
                with rec.setup("step.warmup", cap.id, self.key), torch.cuda.stream(stream):
                    for _ in range(WARMUP):  # from copies: the static state does not move
                        self.fn(tree_map(torch.clone, static), *tree_map(torch.clone, g.inputs))
                warm = _build.launches.copy()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with rec.setup("step.graph", cap.id, self.key), torch.cuda.graph(
                        graph, pool=cache.pool, stream=stream, capture_error_mode="thread_local"):
                    mode = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        out = self.fn(static, *g.inputs)
                        _store(out[0], static)
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
                with rec.setup("step.instantiate", cap.id, self.key):
                    graph.instantiate()
                after = _build.launches.copy()
            finally:  # warm-up and capture launches not counted
                _build.launches.clear()
                _build.launches.update(before)
            counts = after - warm
            if warm - before != collections.Counter({k: WARMUP * n for k, n in counts.items()}):
                raise RuntimeError(f"{self.key}: the warm-up and the capture launched different "
                                   f"kernels ({warm} after {before}, then {after})")
        g.outputs, g.graph, g.counts, g.capture = tuple(out[1:]), graph, counts, cap.span
        self.captures += 1

    def node_counts(self) -> list:
        """The number of nodes in each graph (cuGraphGetNodes, from libcuda)."""
        import ctypes

        cuda = ctypes.CDLL("libcuda.so.1")
        out = []
        for g in self._graphs.values():
            n = ctypes.c_size_t(0)
            err = cuda.cuGraphGetNodes(ctypes.c_void_p(g.graph.raw_cuda_graph()), None,
                                       ctypes.byref(n))
            if err:
                raise RuntimeError(f"cuGraphGetNodes failed with code {err}")
            out.append(n.value)
        return out
