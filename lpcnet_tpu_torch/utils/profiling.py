"""Tracing and per-stage timing (the port of lpcnet_tpu/utils/profiling.py).

  * trace(log_dir): a torch.profiler trace of the CPU and, where there is
    one, the card, written as a chrome trace (*.pt.trace.json.gz) under
    log_dir; nothing when log_dir is empty. Recording the host's operators
    slows the host (chip_smoke.py's [profile] lines measure by how much).
  * parse_trace_utilization(log_dir): the device's occupancy and the duty
    cycle of the port's sample kernels, read from the newest trace's
    device events.
  * StageTimer: named wall-clock stages, fenced by a synchronise of the
    card, so that a stage measures the device's work rather than its
    enqueue.
"""
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

# the __global__ entry points of every hand-written sample kernel (the
# instances of csrc/sample_loop.cuh that csrc/*.cu build): plan L and T
SAMPLE_KERNELS = ("sample_l_kernel", "sample_t_kernel")
# what Kineto files under a device event's "cat"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def _fence(fence: Any) -> None:
    """Wait for the card when fence is a CUDA tensor or device."""
    if isinstance(fence, torch.Tensor):
        dev = fence.device
    elif isinstance(fence, (torch.device, str)):
        dev = torch.device(fence)
    else:
        raise TypeError(f"a fence is a tensor or a device, not "
                        f"{type(fence).__name__}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Wall-clock seconds per named stage; fences the card's work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence: Any = None):
        """Times the block; fence (a tensor or a device): on a CUDA one,
        the clock stops after torch.cuda.synchronize of its device."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + n

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 6),
                    "count": self.counts[k],
                    "mean_ms": round(1e3 * v / max(1, self.counts[k]), 4)}
                for k, v in self.totals.items()}

    def report(self) -> str:
        return json.dumps(self.summary())
