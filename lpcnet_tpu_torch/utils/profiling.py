"""Tracing of the port: spans inside its entry points, the host phases of
a CUDA graph's replay, and Kineto's traces (the port of lpcnet_tpu/utils/
profiling.py, whose StageTimer it replaces with spans).

  * span(name): a block of an entry point's body (vocoder, plc). While
    torch.profiler records, a record_function range
    "lpcnet/<entry>/<name>" on the host, a user_annotation in Kineto's
    trace on the device events' clock; otherwise one flag check. Inside
    the capture of an entry point's CUDA graph (graphs.compile_step), two
    timing events at its edges (torch.cuda.Event(enable_timing=True,
    external=True)), which the graph keeps as event-record nodes: every
    replay times the span again with no host work. A span opened with
    joined=True starts at the end event of the span before it. The events
    belong to the captured step (one per entry point and signature); an
    eager call records none.
  * The replay path (graphs.CompiledStep): untraced, each replay appends
    its host ms in three phases (copy_in, launch, clone_out) to
    replay_host[entry], bounded to REPLAY_RECORD replays; traced, the
    phases are record_function ranges. The spans of every
    SPAN_READ_EVERY-th untraced replay, and of the last one before a
    traced call, are read into span_ms and span_calls (span_ms_per_call)
    at the start of the next call, if its events have completed, as they
    have after a synchronize; nothing waits on an event. Traced replays
    are not read: CUPTI stretches a traced replay's kernels.
  * counters: events the entry points count on the host as they are
    called, by name (a replay runs no Python, so nothing in a graph
    counts).
  * trace(log_dir): a torch.profiler trace of the CPU and, where there is
    one, the card, written as a chrome trace (*.pt.trace.json.gz) under
    log_dir; nothing when log_dir is empty. Recording the host's operators
    slows the host (chip_smoke.py's [profile] lines measure by how much).
  * parse_trace_utilization(log_dir): the device's occupancy and the duty
    cycle of the port's sample kernels, read from the newest trace's
    device events.
"""
import collections
import contextlib
import functools
import glob
import gzip
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

# the __global__ entry points of every hand-written sample kernel (the
# instances of csrc/sample_loop.cuh that csrc/*.cu build): plan L and T
SAMPLE_KERNELS = ("sample_l_kernel", "sample_t_kernel")
# what Kineto files under a device event's "cat"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the untraced replays whose host ms each entry point keeps (the newest):
# every replay of a 30-s window at one frame a call (~12,500 at 2.4 ms)
REPLAY_RECORD = 1 << 15
# untraced replays a step's spans are read after: one in this many (a read
# holds the host ~25 us a span on an H100 host, ~0.12 ms for PLC's four)
SPAN_READ_EVERY = 64

# host ms of the untraced replays, by entry point: (copy_in, launch,
# clone_out) per replay, the newest REPLAY_RECORD
replay_host: Dict[str, collections.deque] = collections.defaultdict(
    functools.partial(collections.deque, maxlen=REPLAY_RECORD))
# device ms in each span of the untraced replays read (SPAN_READ_EVERY), by
# (entry point, span), and the replays read, by entry point
span_ms: Dict[Tuple[str, str], float] = collections.defaultdict(float)
span_calls: collections.Counter = collections.Counter()
# what the entry points count on the host, by name: "dred.dframes" and
# "dred.payloads", a stream's dframe encoded and its payload made
# (DREDCodec.step)
counters: collections.Counter = collections.Counter()

# a span's entry point, the list that collects a capture's span events, the
# last span's end event, and every event recorded in the capture
_local = threading.local()
_STATE = ("entry", "events", "last", "recorded")
# (span name, start event, end event) of a captured step, in the order the
# spans ended
SpanEvents = List[Tuple[str, Any, Any]]


def recording() -> bool:
    """Whether torch.profiler (or the autograd profiler) records."""
    return torch.autograd.profiler._is_profiler_enabled


def host_range(entry: str, name: str):
    """A record_function range "lpcnet/<entry>/<name>"."""
    return torch.profiler.record_function(f"lpcnet/{entry}/{name}")


@contextlib.contextmanager
def entry_point(name: str, events: Optional[SpanEvents] = None):
    """Inside, spans belong to the entry point `name` (graphs.jit and
    compile_step open it around fn); events: the list that collects the
    span events of the capture running inside. Yields the list of every
    event the spans record inside: the capture's nodes refer to them, so
    the caller holds it until the capture has ended, a failed one too.
    Nests, and restores on exit."""
    before = tuple(getattr(_local, k, None) for k in _STATE)
    recorded: List[Any] = []
    _local.entry, _local.events, _local.last, _local.recorded = (
        name, events, None, recorded)
    try:
        yield recorded
    finally:
        for k, v in zip(_STATE, before):
            setattr(_local, k, v)


def _timing_event():
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    _local.recorded.append(ev)
    return ev


@contextlib.contextmanager
def span(name: str, joined: bool = False):
    """A block of an entry point's body: its host range while the profiler
    records, its two timing events inside the capture of the entry point's
    graph (module docstring); nothing else. joined=True: the span starts
    at the end event of the entry point's span before it, which the
    caller ends just before this one, with no kernel in between (each
    event node costs the replay a few us)."""
    entry = getattr(_local, "entry", None)
    events = getattr(_local, "events", None)
    rng = host_range(entry, name) if recording() else None
    start = None
    if events is not None and torch.cuda.is_current_stream_capturing():
        start = _local.last if joined and _local.last is not None \
            else _timing_event()
    if rng is None:
        yield
    else:
        with rng:
            yield
    if start is not None:
        _local.last = end = _timing_event()
        events.append((name, start, end))


def read_spans(entry: str, events: SpanEvents) -> bool:
    """After a replay whose graph holds `events`: if its last event has
    completed (it follows the others on the capture's stream), adds each
    span's device ms to span_ms and one call to span_calls[entry], and
    returns True; never waits."""
    if not events or not events[-1][2].query():
        return False
    for name, start, end in events:
        span_ms[entry, name] += start.elapsed_time(end)
    span_calls[entry] += 1
    return True


def span_ms_per_call(name: str) -> Optional[float]:
    """Device ms a read replay spent in the spans called `name` (summed
    over the entry points that have one); None where none was read."""
    keys = [k for k in span_ms if k[1] == name and span_calls[k[0]]]
    if not keys:
        return None
    return sum(span_ms[k] / span_calls[k[0]] for k in keys)


def replay_host_ms() -> List[float]:
    """The host ms (copy_in + launch + clone_out) of each recorded
    untraced replay, of every entry point."""
    return [sum(r) for rec in replay_host.values() for r in rec]


@contextlib.contextmanager
def trace(log_dir: Optional[str], cpu: bool = True):
    """torch.profiler over the CPU and every CUDA device while the block
    runs, its chrome trace gzipped under log_dir; a no-op when log_dir is
    empty. cpu=False records the devices' activity alone: the host then
    spends less on each operator it launches, so a host-bound call keeps
    closer to its untraced pace."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if not acts:
        raise RuntimeError("trace(cpu=False) needs a CUDA device")
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir, use_gzip=True)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def newest_trace(log_dir: str) -> Optional[str]:
    """The newest *.json.gz under log_dir (or log_dir itself if it is
    one), None if there is none."""
    if os.path.isfile(log_dir) and log_dir.endswith(".json.gz"):
        return log_dir
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.json.gz"),
                             recursive=True), key=os.path.getmtime)
    return paths[-1] if paths else None


def parse_trace_utilization(log_dir: str) -> Optional[Dict[str, Any]]:
    """The device's occupancy over the newest trace under log_dir.

    Device events are Kineto's complete events ("ph" "X") of category
    "kernel", "gpu_memcpy" or "gpu_memset". The span runs from the first
    one's start to the last one's end; busy time sums the top-level events
    (an event that starts before the one kept last has ended is dropped,
    as in the JAX package). device_occupancy = busy / span;
    duty_cycle = the summed time of the sample kernels (SAMPLE_KERNELS)
    over the span; busy_us_by_class: the six kernel names with the most
    busy time. None when the trace holds no device event."""
    path = newest_trace(log_dir)
    if path is None:
        return None
    with gzip.open(path) as f:
        evs = json.load(f).get("traceEvents", [])
    ops = [e for e in evs if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and "dur" in e]
    if not ops:
        return None
    ops.sort(key=lambda e: (e["ts"], -e["dur"]))
    top: List[Dict[str, Any]] = []
    cur_end = -1.0
    for e in ops:
        if e["ts"] >= cur_end:
            top.append(e)
            cur_end = e["ts"] + e["dur"]
    span = max(e["ts"] + e["dur"] for e in ops) - min(e["ts"] for e in ops)
    busy = sum(e["dur"] for e in top)
    by_class: Dict[str, float] = {}
    for e in top:
        by_class[e["name"]] = by_class.get(e["name"], 0.0) + e["dur"]
    top_classes = dict(sorted(by_class.items(), key=lambda kv: -kv[1])[:6])
    kern = sum(e["dur"] for e in ops if e.get("cat") == "kernel"
               and any(k in e["name"] for k in SAMPLE_KERNELS))
    span = max(span, 1e-9)
    return {"trace": os.path.basename(path),
            "span_us": round(span, 1), "busy_us": round(busy, 1),
            "duty_cycle": round(min(kern / span, 1.0), 4),
            "device_occupancy": round(min(busy / span, 1.0), 4),
            "busy_us_by_class": {k: round(v, 1)
                                 for k, v in top_classes.items()}}
