"""A solve's chunk as one captured CUDA graph, cached across calls.

Counterpart of the reference's compiled chunk (``bsls_tpu/solvers/base.py``):
``_run_chunk``, ``jax.jit`` over a ``lax.scan`` of the chunk's steps, makes a
chunk one device program dispatched once, and ``cached_executable`` /
``_aot_chunk_executable`` compile it before the clock and keep it for later
``solve()`` calls.  Here the chunk of ``base.make_chunk_runner`` (``refresh``
and ``steps`` solver steps, the per-step traces) is captured once with
``torch.cuda.graph`` and replayed: a chunk costs the host one graph launch
instead of ~100 launches a step.

What a graph reads:

* its input buffers, which ``ChunkProgram.run`` fills before each replay:
  the state, the right-hand side ``b``, the scale ``bottom_scale`` of every
  stacked operator (sqrt(rho): new every outer of the augmented-Lagrangian
  loop) and L, a 0-d tensor (the same loop passes a new L once rho grows);
* every other tensor of the operator (ELL indices and values, band pages,
  buckets, perm) where it lies.  Their identities are part of the cache key,
  and the cache holds them weakly: a program whose operator has been freed
  is never replayed, and is dropped.

What leaves a replay is a copy: the state and the traces are copied out of
the graph's output buffers, so that the next replay (the next chunk, or
another solve of the same key) never overwrites what a caller holds.

The cache key (``chunk_key``) is the reference's: the method, the options
that the chunk reads, the chunk length, the shapes and dtypes of the state
and of the per-call inputs, and the identity of the operator's tensors.  It
holds at most ``GRAPH_CACHE_MAX`` programs and drops the least recently
used first; a dropped program's graph and memory pool are released when no
solve in progress holds it.

A capture runs one throwaway step on a side stream first (the first launch
of every operation, the kernel library's load), then captures in the
``thread_local`` error mode: a ``BatchQueue`` captures from its worker
thread while other threads may use the card.  A launch made while capturing
is counted into the program's record and added to the launch counters at
each replay (``ops/cudalib.py``).  Nothing falls back: a capture or replay
that fails raises.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import OrderedDict

import torch

from ..ops import cudalib
from ..ops.layout import DeviceVStack
from ..utils.profiling import span
from .base import lipschitz_tensor, make_chunk_runner

__all__ = ["GRAPH_CACHE_MAX", "ChunkProgram", "ProgramCache", "chunk_key", "problem_inputs",
           "bind_problem", "graph_runner", "graph_stats"]

# programs kept at once; each holds its graph's private pool (the chunk's
# intermediates and outputs) and its input buffers
GRAPH_CACHE_MAX = 16

# ---------------- the per-call inputs and the operator


def _scales(A) -> list:
    """The ``bottom_scale`` of every stacked operator in ``A``, depth first."""
    if isinstance(A, DeviceVStack):
        return [*_scales(A.top), A.bottom_scale, *_scales(A.bottom)]
    return []


def _bind_scales(A, it):
    if isinstance(A, DeviceVStack):
        top = _bind_scales(A.top, it)
        scale = next(it)
        return dataclasses.replace(A, top=top, bottom_scale=scale,
                                   bottom=_bind_scales(A.bottom, it))
    return A


def problem_inputs(dp) -> list:
    """The tensors of a device problem that change between calls of one
    program: ``b`` and every stacked operator's ``bottom_scale``."""
    return [dp.b, *_scales(dp.A)]


def bind_problem(dp, inputs):
    """``dp`` reading ``inputs`` (in ``problem_inputs`` order) in place of
    its own per-call tensors."""
    return dataclasses.replace(dp, b=inputs[0], A=_bind_scales(dp.A, iter(inputs[1:])))


def _operator(obj, skip: set, tensors: list):
    """Signature of everything in ``obj`` but the per-call inputs (ids in
    ``skip``): each tensor by identity, shape, dtype and device (collected
    into ``tensors``), every other field by value."""
    if isinstance(obj, torch.Tensor):
        if id(obj) in skip:
            return "input"
        tensors.append(obj)
        return ("tensor", id(obj), tuple(obj.shape), str(obj.dtype), str(obj.device))
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                tuple(_operator(getattr(obj, f.name), skip, tensors)
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return tuple(_operator(v, skip, tensors) for v in obj)
    return obj


def _signature(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype), str(t.device)


# ---------------- the state


def _state_leaves(state) -> tuple:
    """(structure, tensors) of a solver state: its fields in order, a tuple
    field one leaf an element, a ``None`` field none.  Every other field must
    be a tensor: a graph cannot read a host value that changes."""
    structure, leaves = [], []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            structure.append((f.name, None))
            continue
        items = v if isinstance(v, tuple) else (v,)
        for t in items:
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{type(state).__name__}.{f.name} is a {type(t).__name__}: a "
                                "captured chunk needs every field of the state on the device")
        structure.append((f.name, len(items) if isinstance(v, tuple) else -1))
        leaves.extend(items)
    return (type(state), tuple(structure)), leaves


def _rebuild(structure, leaves):
    cls, fields = structure
    it, values = iter(leaves), {}
    for name, n in fields:
        values[name] = None if n is None else (next(it) if n < 0 else
                                               tuple(next(it) for _ in range(n)))
    return cls(**values)


def _options(opts):
    """The options a chunk reads: tol and max_iter steer the loop around it."""
    return dataclasses.replace(opts, tol=0.0, max_iter=0)


def chunk_key(opts, steps: int, dp, state) -> tuple:
    """The cache key of a chunk program (the reference's
    ``(opts, method, chunk)`` plus the signature of its arguments): another
    method or options, chunk length, shape or dtype of the state or of ``b``
    and the scales, or another operator tensor gives another key; another
    ``b``, scale or L of the same shapes gives the same."""
    inputs = problem_inputs(dp)
    op = _operator(dp, {id(t) for t in inputs}, [])
    structure, leaves = _state_leaves(state)
    return (_options(opts), int(steps), op,
            tuple(_signature(t) for t in inputs),
            structure, tuple(_signature(t) for t in leaves))


def _copy(dst: list, src: list) -> None:
    if dst:
        torch._foreach_copy_(dst, src)


# ---------------- the program


class ChunkProgram:
    """One chunk of one (method, options, chunk length, operator, shapes):
    its input buffers, the chunk bound to them, and on the card its captured
    graph.  ``run`` fills the buffers from a call's (dp, state, L), launches
    the chunk and copies its outputs out."""

    def __init__(self, dp, solver, opts, L_est, steps: int, state):
        self._structure, leaves = _state_leaves(state)
        self._inputs = [t.clone() for t in problem_inputs(dp)]
        self._L = lipschitz_tensor(L_est, dp.device).clone()
        self._state = [t.clone() for t in leaves]
        dp_in = bind_problem(dp, self._inputs)
        st_in = _rebuild(self._structure, self._state)
        chunk = make_chunk_runner(dp_in, solver, opts, self._L, steps)
        self._body = lambda: chunk(st_in)
        self._first_step = lambda: solver.step(dp_in, st_in, self._L, opts)
        self._graph = None
        self._outputs = None
        self._record = {}
        self.pool_bytes = 0
        self._run_lock = threading.Lock()

    def capture(self) -> None:
        """One throwaway step on a side stream, then the capture of the
        chunk on that stream (``thread_local``: only this thread's calls
        are held to the rules of a capture).  ``pool_bytes`` is what the
        card's reserved memory grew by (the graph's pool, mostly)."""
        dev = self._L.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._first_step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with cudalib.recording() as record:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                st, (tf, tg) = self._body()
        self._record = dict(record)
        self._outputs = [*_state_leaves(st)[1], tf, tg]
        self._graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        # the graph replays without them: dropping the closures drops the
        # operator, which the cache holds weakly
        self._body = self._first_step = None

    def _launch(self) -> list:
        if self._graph is not None:
            self._graph.replay()
            cudalib.add_record(self._record)
            return self._outputs
        if self._L.is_cuda:
            raise RuntimeError("ChunkProgram.run: the chunk was not captured")
        st, (tf, tg) = self._body()  # CPU tensors (the binding's tests): the chunk itself
        return [*_state_leaves(st)[1], tf, tg]

    @property
    def launches(self) -> dict:
        """The kernel launches of one replay, by name (``ops/cudalib.py``)."""
        return cudalib.record_launches(self._record)

    def run(self, dp, state, L_est):
        """(state, (trace_f, trace_gap)) of one chunk from ``state`` on
        ``dp``'s per-call inputs and ``L_est`` (a float or a 0-d tensor);
        everything returned is a fresh tensor."""
        with self._run_lock:
            _copy(self._inputs, problem_inputs(dp))
            if isinstance(L_est, torch.Tensor):
                self._L.copy_(L_est)
            else:
                self._L.fill_(float(L_est))
            _copy(self._state, _state_leaves(state)[1])
            outs = [t.clone() for t in self._launch()]
        return _rebuild(self._structure, outs[:-2]), (outs[-2], outs[-1])


class _Entry:
    """A cached value and weak references to its operator's tensors."""

    def __init__(self, value, tensors, on_death):
        self.value = value
        self.refs = [weakref.ref(t) for t in tensors]
        self.finalizers = [weakref.finalize(t, on_death, id(self)) for t in tensors]

    def alive_for(self, tensors) -> bool:
        return len(self.refs) == len(tensors) and all(
            r() is t for r, t in zip(self.refs, tensors))


class ProgramCache:
    """Values by key, at most ``max_size`` of them, the least recently used
    dropped first.  Each value is tied to its operator's tensors, held
    weakly: once one of them is freed the value is never returned again and
    is dropped at the next ``get`` (a finalizer only notes the death: it may
    run in any thread, even one that is capturing)."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._dead: list = []  # ids of entries whose operator was freed
        self._lock = threading.RLock()
        self.stats = {"captures": 0, "capture_secs": 0.0, "hits": 0, "replays": 0,
                      "evictions": 0}

    def __len__(self) -> int:
        with self._lock:
            self._purge()
            return len(self._entries)

    def values(self) -> list:
        with self._lock:
            self._purge()
            return [e.value for e in self._entries.values()]

    def _purge(self) -> None:
        """Drop the entries whose operator was freed."""
        dead = set()
        while self._dead:
            dead.add(self._dead.pop())
        for k in [k for k, e in self._entries.items() if id(e) in dead]:
            self._drop(k)

    def _drop(self, key) -> None:
        entry = self._entries.pop(key)
        for fin in entry.finalizers:
            fin.detach()
        self.stats["evictions"] += 1

    def clear(self) -> None:
        with self._lock:
            while self._entries:
                self._drop(next(iter(self._entries)))

    def get(self, key, tensors, make):
        """The value of ``key`` while ``tensors`` are the ones it was made
        with; else ``make()``, cached (``make`` runs under the cache's
        lock, so one key is captured once, in the span ``bsls.graph.capture``)."""
        with self._lock:
            self._purge()
            entry = self._entries.get(key)
            if entry is not None and not entry.alive_for(tensors):
                self._drop(key)  # an id taken again by a new tensor
                entry = None
            if entry is not None:
                self._entries.move_to_end(key)
                self.stats["hits"] += 1
                return entry.value
            with span("graph.capture") as made:
                value = make()
            self.stats["captures"] += 1
            self.stats["capture_secs"] += made.secs
            while len(self._entries) >= self.max_size:
                self._drop(next(iter(self._entries)))
            self._entries[key] = _Entry(value, tensors, self._dead.append)
            return value


_PROGRAMS = ProgramCache(GRAPH_CACHE_MAX)


def graph_stats() -> dict:
    """Captures (and their seconds), cache hits, replays and evictions in
    this process, and the programs cached now with their pools' bytes."""
    with _PROGRAMS._lock:
        return {**_PROGRAMS.stats, "cached": len(_PROGRAMS),
                "pool_bytes": [p.pool_bytes for p in _PROGRAMS.values()]}


def _capture(dp, solver, opts, L_est, steps, state) -> ChunkProgram:
    program = ChunkProgram(dp, solver, opts, L_est, steps, state)
    with torch.cuda.device(dp.device):
        program.capture()
    return program


def graph_runner(dp, solver, opts, L_est, steps: int, state):
    """run(state) -> (state, (trace_f, trace_gap)): the chunk of ``steps``
    steps as the cached program of its key (captured now on a miss; a hit
    launches nothing here), replayed once a call with ``dp``'s ``b`` and
    scales and ``L_est``.  ``run.captures`` is 1 when this call captured
    it, else 0; ``run.launches`` the kernel launches of one replay.  CUDA
    tensors only."""
    if dp.device.type != "cuda" or dp.sharded:
        raise ValueError("graph_runner: an unsharded problem on a CUDA device only")
    key = chunk_key(opts, steps, dp, state)
    tensors: list = []
    _operator(dp, {id(t) for t in problem_inputs(dp)}, tensors)
    made = []
    program = _PROGRAMS.get(key, tensors, lambda: made.append(1) or _capture(
        dp, solver, opts, L_est, steps, state))

    def run(st):
        out = program.run(dp, st, L_est)
        with _PROGRAMS._lock:
            _PROGRAMS.stats["replays"] += 1
        return out

    run.program = program
    run.captures = len(made)
    run.launches = program.launches
    return run
