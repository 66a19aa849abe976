"""The counterpart of jax.jit and jax.disable_jit for the port's entry
points: a call captured as one CUDA graph and replayed.

    step = jit(fn, "Synthesizer.synthesize")
    out = step(state, feats)        # first call of this signature: eager
    out = step(state, feats)        # second: capture, then one replay
    out = step(state, feats)        # later calls: one replay
    with disabled():                # jax.disable_jit(): fn runs eagerly
        out = step(state, feats)

The arguments and the outputs of fn are trees of dicts, tuples and lists
whose leaves are tensors (or other values, which are part of the
signature and baked into the graph). The signature of a call is the tree
with each tensor leaf's shape, dtype and device: one graph per signature,
as JAX compiles one program per abstract signature. A torch.Generator
leaf is held by identity: a CUDA one is registered with its graph, so a
replay draws from the generator's state at that moment, what an eager
call would draw there, and advances it by as much. fn may differentiate
inside (torch.autograd.grad): the capture holds the backward pass too. A
replay copies the arguments into the graph's static inputs (contiguous
tensors of those shapes) and returns clones of its outputs, outputs that
are inputs passed through included, so that no result aliases the
graph's memory.

The first call of a signature runs fn eagerly and is the capture's
warm-up: a caller that makes one call of a shape (a CLI chunk, an
evaluation) pays no capture, and a signature is captured only when it
comes again (the CAPTURE_CALL-th call). On the CPU (no graphs there) and
inside disabled(), fn runs eagerly. A capture that fails raises
RuntimeError naming the entry point; nothing falls back to eager calls. A
kernel's launch counter ticks in the eager calls and the capture, never
in a replay. The module's `captures` and `replays` count graphs made and
replayed per entry point's name, as kernels/sample_cuda.py counts
launches per kernel; a jit's clear() drops its graphs, and
graph_nodes(graph) counts a kept graph's nodes.

    body = loop_step(fn, bufs, "Engine.sample_step")
    for _ in range(160):            # the body of a loop, as XLA compiles
        body()                      # a scan's body once: fn(bufs) in place

loop_step is the counterpart of a jax.lax.scan whose body is compiled
once: fn updates the tensors of bufs in place and returns nothing; its
first call runs eagerly, the CAPTURE_CALL-th captures it on bufs
themselves, and it and every later call replay the graph, with nothing
copied in or out. The caller writes each iteration's inputs into bufs and
reads the results from them.
"""
import collections
import contextlib
import ctypes
import inspect
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from . import profiling

# compile_step's eager calls of fn on a side stream before its capture: the
# first call builds whatever the call makes once (cuBLAS handles, cuFFT
# plans, the kernels' libraries, device constants, the tables' operands),
# which a capture cannot
WARMUP_CALLS = 1
# the call of a signature at which jit captures it; the calls before it run
# eagerly and are its warm-up, so compile_step warms up no more
CAPTURE_CALL = 2

# graphs captured and replayed, by the entry point's name
captures: collections.Counter = collections.Counter()
replays: collections.Counter = collections.Counter()

_local = threading.local()


def is_disabled() -> bool:
    """Whether this thread is inside disabled()."""
    return getattr(_local, "disabled", False)


@contextlib.contextmanager
def disabled():
    """Inside, every jit entry point this thread calls runs its function
    eagerly (the counterpart of jax.disable_jit()). Nests, and restores on
    exit; other threads are not affected."""
    before, _local.disabled = is_disabled(), True
    try:
        yield
    finally:
        _local.disabled = before


def flatten(tree) -> Tuple[List[Any], Hashable]:
    """(the leaves of tree in order, its structure): dicts (by key, in
    order), tuples and lists are nodes, anything else a leaf."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return ("dict", tuple(t), tuple(walk(v) for v in t.values()))
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        leaves.append(t)
        return "*"

    return leaves, walk(tree)


def unflatten(structure: Hashable, leaves: List[Any]):
    """The tree of `structure` (from flatten) with `leaves` in order."""
    it = iter(leaves)

    def build(s):
        if s == "*":
            return next(it)
        if s[0] == "dict":
            return {k: build(v) for k, v in zip(s[1], s[2])}
        items = [build(v) for v in s[1]]
        return tuple(items) if s[0] == "tuple" else items

    return build(structure)


def _leaf_key(x) -> Hashable:
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"a jit argument's leaf must be a tensor or "
                        f"hashable, not {type(x).__name__}") from None
    return ("static", type(x), x)


def signature(args) -> Hashable:
    """The cache key of a call: the argument tree with each tensor leaf's
    shape, dtype and device, and each other leaf's value."""
    leaves, structure = flatten(args)
    return structure, tuple(_leaf_key(x) for x in leaves)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _static(x):
    """A contiguous copy of a tensor leaf: the graph's input."""
    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)


class CompiledStep:
    """A captured call of fn: step(*args) copies its arguments into the
    graph's static inputs, replays the graph and returns clones of its
    outputs. `replays` counts its replays (the module's `replays` those of
    every graph of its name); `capture_s` is the host time of the capture
    (the graph's instantiation included, its warm-up calls not); `spans`
    the span events the graph records (profiling.span).

    Untraced, a replay appends its host ms in three phases (copy_in: the
    arguments' check and copies, launch: graph.replay(), clone_out) to
    profiling.replay_host[name]. While torch.profiler records, the phases
    are record_function ranges ("lpcnet/<name>/copy_in", ...). A call
    first reads the spans of the untraced replay before it into
    profiling.span_ms (profiling.read_spans, which never waits; outside
    the three phases) when that replay is the profiling.SPAN_READ_EVERY-th
    since the last read, or the call is traced; traced replays are not
    read."""

    def __init__(self, graph: torch.cuda.CUDAGraph, args: Tuple, out: Any,
                 name: str = "compile_step", capture_s: float = 0.0,
                 spans: profiling.SpanEvents = ()):
        self.graph, self.args, self.out, self.name = graph, args, out, name
        self.capture_s = capture_s
        self.spans = list(spans)
        self.key = signature(args)
        self._inputs = [x for x in flatten(args)[0]
                        if isinstance(x, torch.Tensor)]
        self._out_leaves, self._out_structure = flatten(out)
        self.replays = 0
        self._unread = 0       # untraced replays since the last read

    def _copy_in(self, args) -> None:
        if signature(args) != self.key:
            raise ValueError(f"{self.name}: a compiled step takes arguments "
                             f"of the shapes it was captured with")
        given = [x for x in flatten(args)[0] if isinstance(x, torch.Tensor)]
        for static, x in zip(self._inputs, given):
            static.copy_(x)

    def _launch(self) -> None:
        self.graph.replay()
        self.replays += 1
        replays[self.name] += 1

    def _clone_out(self):
        return unflatten(self._out_structure,
                         [_clone(x) for x in self._out_leaves])

    @torch.no_grad()
    def __call__(self, *args):
        traced = profiling.recording()
        if self._unread and (traced or self._unread
                             >= profiling.SPAN_READ_EVERY):
            self._unread = 0
            profiling.read_spans(self.name, self.spans)
        if traced:
            return self._traced(args)
        t0 = time.perf_counter()
        self._copy_in(args)
        t1 = time.perf_counter()
        self._launch()
        self._unread += bool(self.spans)
        t2 = time.perf_counter()
        out = self._clone_out()
        t3 = time.perf_counter()
        profiling.replay_host[self.name].append(
            (1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2)))
        return out

    def _traced(self, args):
        with profiling.host_range(self.name, "copy_in"):
            self._copy_in(args)
        with profiling.host_range(self.name, "launch"):
            self._launch()
        self._unread = 0
        with profiling.host_range(self.name, "clone_out"):
            return self._clone_out()


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with keep_graph=True (the
    driver's cuGraphGetNodes on its cudaGraph_t)."""
    get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t)]
    get.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = get(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def _device(args, name: str) -> Optional[torch.device]:
    """The one device of args' tensor leaves (None without one); raises
    ValueError when they span more than one."""
    devices = {x.device for x in flatten(args)[0]
               if isinstance(x, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"{name}: the arguments span more than one device: "
                         f"{sorted(map(str, devices))}")
    return next(iter(devices), None)


def _capture_error(name: str, e: Exception) -> RuntimeError:
    return RuntimeError(f"{name}: the call could not be captured as a CUDA "
                        f"graph: {e}")


def compile_step(fn: Callable, example_args: Tuple,
                 name: str = "compile_step", pool=None,
                 warmup: int = WARMUP_CALLS,
                 keep_graph: bool = False,
                 capture_error_mode: str = "global") -> CompiledStep:
    """The counterpart of jax.jit(fn) on the card for one signature: fn
    called `warmup` times on a side stream (cuBLAS handles, cuFFT plans,
    the kernels' libraries and per-device constants exist before the
    capture; 0 when the caller has called fn eagerly already), then one
    call of fn on static copies of example_args captured in a
    torch.cuda.CUDAGraph (in `pool`, a graph_pool_handle, or a pool of its
    own). The CUDA generators among the arguments are registered with the
    graph (the warm-up calls draw from them as eager calls do). With
    keep_graph the graph keeps its cudaGraph_t for graph_nodes.
    capture_error_mode is torch.cuda.graph's: "thread_local" lets other
    threads make CUDA calls during the capture (a process group's watchdog
    does). Raises RuntimeError on a device that is not CUDA (there are no
    graphs there) and when the capture fails; it never falls back to eager
    calls. An error of fn in a warm-up call propagates as fn raised it."""
    example_args = tuple(example_args)
    dev = _device(example_args, name)
    if dev is None or dev.type != "cuda":
        raise RuntimeError(f"{name} captures a CUDA graph; the arguments "
                           f"are on {dev}")
    static = unflatten(flatten(example_args)[1],
                       [_static(x) for x in flatten(example_args)[0]])
    if warmup:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), profiling.entry_point(name):
            for _ in range(warmup):
                fn(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    for x in flatten(example_args)[0]:
        if isinstance(x, torch.Generator) and x.device.type == "cuda":
            graph.register_generator_state(x)
    spans: profiling.SpanEvents = []
    t0 = time.perf_counter()
    try:
        # recorded: the span events that the capture's nodes refer to,
        # alive until the capture has ended
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode=capture_error_mode), \
                profiling.entry_point(name, spans) as recorded:
            out = fn(*static)
        del recorded
        if keep_graph:
            graph.instantiate()
    except Exception as e:
        raise _capture_error(name, e) from e
    captures[name] += 1
    return CompiledStep(graph, static, out, name, time.perf_counter() - t0,
                        spans)


class jit:
    """fn behind a per-signature cache of compiled steps (compile_step),
    which share one memory pool: on CUDA tensors the first call of a
    signature runs fn eagerly, the CAPTURE_CALL-th captures it, and that
    call and every later one replay its graph. On the CPU, or inside
    disabled(), fn runs eagerly and nothing is counted or cached. Raises
    ValueError for arguments on more than one device. A bound method is
    held weakly, so that an engine's graphs and pool are freed with the
    engine (it holds its jit, which would otherwise hold it).
    capture_error_mode: compile_step's, for an entry point whose capture
    runs beside another thread's CUDA calls."""

    def __init__(self, fn: Callable, name: str,
                 capture_error_mode: str = "global"):
        self.fn, self.name = fn, name
        self.capture_error_mode = capture_error_mode
        self.clear()

    def clear(self):
        """Drops every graph and the pool (jax.clear_caches for this
        entry point): the next call of any signature runs eagerly."""
        self.steps: Dict[Hashable, CompiledStep] = {}
        self._calls: Dict[Hashable, int] = {}
        self.pool = None

    @property
    def fn(self) -> Callable:
        fn = self._fn()
        if fn is None:
            raise ReferenceError(f"{self.name}: its object is gone")
        return fn

    @fn.setter
    def fn(self, fn: Callable):
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)

    def __call__(self, *args):
        dev = _device(args, self.name)
        if is_disabled() or dev is None or dev.type != "cuda":
            with profiling.entry_point(self.name):
                return self.fn(*args)
        key = signature(args)
        step = self.steps.get(key)
        if step is None:
            n = self._calls.get(key, 0) + 1
            if n < CAPTURE_CALL:
                with profiling.entry_point(self.name):
                    out = self.fn(*args)
                self._calls[key] = n
                return out
            if not self.steps:
                # no graph of this jit holds the pool: the graph of a
                # failed capture releases it whenever it is freed, and a
                # released pool cannot take another capture
                self.pool = torch.cuda.graph_pool_handle()
            step = compile_step(self.fn, args, self.name, self.pool,
                                warmup=0,
                                capture_error_mode=self.capture_error_mode)
            self.steps[key] = step
            del self._calls[key]
        return step(*args)


class loop_step:
    """fn(bufs), which updates the tensors of the tree bufs in place and
    returns nothing, as the body of a loop over those buffers (module
    docstring). On CUDA buffers the first call runs fn eagerly (the
    capture's warm-up), the CAPTURE_CALL-th captures it on bufs themselves
    and replays it, and every later call replays it. On the CPU, or inside
    disabled(), fn runs eagerly. The tensors of bufs must stay the ones
    the step was made with: the graph reads and writes their memory. A
    failed capture raises RuntimeError naming the step; nothing falls back
    to eager calls. `calls` counts the eager calls on the card before the
    capture, `replays` the replays, `capture_s` the capture's host time.
    fn's spans (profiling.span) belong to the entry point `name`; their
    events in the graph are read as CompiledStep reads them (every
    profiling.SPAN_READ_EVERY-th untraced replay and the last before a
    traced one, at the start of the next call, never waiting)."""

    def __init__(self, fn: Callable, bufs, name: str):
        self.fn, self.bufs, self.name = fn, bufs, name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = self.replays = 0
        self.capture_s = 0.0
        self.device = _device(bufs, name)
        self.spans: profiling.SpanEvents = []
        self._unread = 0       # untraced replays since the last read

    def _eager(self) -> None:
        with profiling.entry_point(self.name):
            self.fn(self.bufs)

    def __call__(self) -> None:
        dev = self.device
        if is_disabled() or dev is None or dev.type != "cuda":
            self._eager()
            return
        if self.graph is None:
            if self.calls + 1 < CAPTURE_CALL:
                self._eager()
                self.calls += 1
                return
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph), \
                        profiling.entry_point(self.name,
                                              self.spans) as recorded:
                    self.fn(self.bufs)
                del recorded
            except Exception as e:
                raise _capture_error(self.name, e) from e
            self.capture_s = time.perf_counter() - t0
            self.graph = graph
            captures[self.name] += 1
        traced = profiling.recording()
        if self._unread and (traced or self._unread
                             >= profiling.SPAN_READ_EVERY):
            self._unread = 0
            profiling.read_spans(self.name, self.spans)
        self.graph.replay()
        self._unread = 0 if traced else self._unread + bool(self.spans)
        self.replays += 1
        replays[self.name] += 1
