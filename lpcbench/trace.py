"""Device traces of a run's calls, reduced to what the per-layer metrics
read.

record(fn) runs fn under torch.profiler (host and device activity),
exports Kineto's chrome trace into a temporary directory, and returns a
Trace: the device operations (Kineto's complete events of category
kernel, gpu_memcpy or gpu_memset) as (name, start_us, dur_us), and the
host's operator and runtime events, used only to say what the host was
doing in the device's idle gaps. Busy time is the union of the device
operations' intervals, so overlapping operations count once.
"""
import gzip
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")

Event = Tuple[str, float, float]        # name, start us, duration us


@dataclass
class Trace:
    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    wall_s: float = 0.0       # host clock over fn, to the device idle

    def busy_us(self, match: Callable[[str], bool] = lambda n: True
                ) -> float:
        """Microseconds in which a matching device operation ran."""
        return sum(b - a for a, b in _union(
            [(t, t + d) for n, t, d in self.device if match(n)]))

    def top_ops(self, n: int = 10) -> List[List]:
        """The n device operations with the most time, seconds each."""
        by: dict = {}
        for name, _, d in self.device:
            by[name] = by.get(name, 0.0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us * 1e-6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest gaps between device operations, each named by the
        host event that covers most of it (innermost first), seconds."""
        spans = _union([(t, t + d) for _, t, d in self.device])
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in
                       zip(spans, spans[1:]) if a1 > b0),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for g0, g1 in gaps:
            best, cover, best_d = "host: no traced event", 0.0, float("inf")
            for name, t, d in self.host:
                c = min(g1, t + d) - max(g0, t)
                if c > cover or (c > 0 and c == cover and d < best_d):
                    best, cover, best_d = name, c, d
            out.append([best, (g1 - g0) * 1e-6])
        return out


def _union(iv: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def record(fn: Callable[[], None]) -> Trace:
    """fn's device and host activity, fn ending with the device idle."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path) as f:
            events = json.load(f).get("traceEvents", [])
    tr = Trace(wall_s=wall)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            tr.device.append(ev)
        elif e.get("cat") in HOST_CATS:
            tr.host.append(ev)
    return tr
