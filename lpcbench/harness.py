"""The benchmark's run: one cell of BENCHMARK.json, one process.

    run(workload, seed, seconds, trace) -> the result line (a dict)

Everything is found by name from BENCHMARK.json: the cell's configuration
file, its traffic mix traffic/<traffic>.json, the driver that the mix
names (drivers/<driver>.py), the cell's correctness limits
(limits/<workload>.json) and each metric's reader (metrics/<name>.py).

A run: the driver sets the cell up (weights, inputs, the program's state,
and every call shape warmed up: the first call of a shape runs eagerly,
the second captures the CUDA graph that later calls replay), then the
window: calls one after another, each timed on the host's clock up to a
synchronize, until the first call that ends at or after `seconds`. With
trace=1 a short traced segment of calls follows the window (retaken when
it holds no sample-kernel record in a cell whose calls launch one). Then
the device's peak memory is read, the program's state is freed, and the
driver's plain reference checks the answers it kept from the window; each
number it compares is held to its limit.

A driver module has setup(ctx) -> cell, where the cell gives:
  call()            one call of the window (returns with work enqueued)
  keep(i, t)        after call i has ended at t s into the window, outside
                    its time: keep what the check will need
  work(n) -> dict   what n calls did: "audio_s", "samples", "model_flops",
                    "sample_loop" (flops and bytes), "frames"
  traced_calls      calls in the traced segment
  sample_kernels    names of the sample kernels the calls launch (a
                    trace without one of them is retaken); () for none
  check() -> dict   {number: value}, after free()
  free()            drop the program's state
  counters() -> dict
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from . import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "lpcnet_tpu")


def load_module(path: str, name: str):
    """The Python file at `path` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def find(bench: Dict[str, Any], key: str, name: str) -> Dict[str, Any]:
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")


def cell_parts(workload: str, bench: Optional[Dict[str, Any]] = None):
    """(cell entry, configuration, traffic mix, limits, driver module) of
    a workload, each loaded from its file."""
    bench = bench or benchmark()
    cell = find(bench, "workloads", workload)
    config = _json(os.path.join(ROOT, find(bench, "configs",
                                           cell["config"])["file"]))
    traffic = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", workload + ".json"))
    driver = load_module(os.path.join(HERE, "drivers",
                                      traffic["driver"] + ".py"),
                         "lpcbench_driver_" + traffic["driver"])
    return cell, config, traffic, limits, driver


def cell_metrics(bench: Dict[str, Any], workload: str, traced: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of `workload` reports: end-to-end untraced, the
    per-layer ones traced; each applies where its "workloads" lists the
    cell, or everywhere without that key."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(device) -> Dict[str, Any]:
    """The card's name, count and power limit (nvidia-smi)."""
    line = {"kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        line["nvidia_smi"] = res.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        line["nvidia_smi"] = f"not read: {e}"
    return line


class Run:
    """What a run measured; the metric readers read it."""

    def __init__(self):
        self.setup_s = 0.0
        self.calls: List[tuple] = []           # (start s, end s) in window
        self.window_s = 0.0
        self.work: Dict[str, Any] = {}          # of the window's calls
        self.call_work: Dict[str, Any] = {}     # of one call
        self.trace: Optional[tracing.Trace] = None
        self.traced_calls = 0
        self.traced_s = 0.0

    def call_ms(self) -> List[float]:
        return [1e3 * (b - a) for a, b in self.calls]

    def p(self, q: int) -> float:
        """The q-th percentile of the window's call times, ms."""
        ms = self.call_ms()
        if len(ms) < 2:
            return ms[0]
        return statistics.quantiles(ms, n=100, method="inclusive")[q - 1]

    def untraced_call_s(self) -> float:
        """Mean wall time of a window call."""
        return self.window_s / len(self.calls)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_calls(cell, device, run: Run, seconds: float) -> None:
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        cell.call()
        _sync(device)
        b = time.perf_counter()
        run.calls.append((a - t0, b - t0))
        cell.keep(i, b - t0)
        i += 1
        if b - t0 >= seconds:
            break
    run.window_s = run.calls[-1][1]


def _traced(cell, run: Run) -> None:
    def segment():
        for _ in range(cell.traced_calls):
            cell.call()

    for take in range(3):
        tr = tracing.record(segment)
        run.traced_s = tr.wall_s
        has_sample = any(any(k in n for k in cell.sample_kernels)
                         for n, _, _ in tr.device)
        print(json.dumps({"trace_take": take + 1,
                          "device_ops": len(tr.device),
                          "sample_kernel_records": has_sample}),
              file=sys.stderr, flush=True)
        if tr.device and (has_sample or not cell.sample_kernels):
            break
    run.trace = tr
    run.traced_calls = cell.traced_calls


def run(workload: str, seed: int, seconds: float, traced: bool,
        device=None, t_start: Optional[float] = None, control: bool = False,
        overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of a cell; returns the result line. device: None is the
    card (with a check that there are the cards the cell asks for); tests
    pass "cpu". control: the cell's lower-precision control in the
    program's place. overrides: test-only changes to the configuration
    and the traffic mix ({"config": {...}, "traffic": {...}})."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark()
    cell_entry, config, traffic, limits, driver = cell_parts(workload, bench)
    if overrides:
        config = _merge(config, overrides.get("config", {}))
        traffic = _merge(traffic, overrides.get("traffic", {}))
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark measures the "
                             "card and runs nowhere else")
        if torch.cuda.device_count() < cell_entry["chips"]:
            raise SystemExit(f"{workload} needs {cell_entry['chips']} "
                             f"cards; {torch.cuda.device_count()} found")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
        print(json.dumps({"card": card_line(device)}), flush=True)
    ctx = {"config": config, "traffic": traffic, "seed": seed,
           "seconds": seconds, "device": device, "root": ROOT,
           "control": control}
    cell = driver.setup(ctx)
    rec = Run()
    rec.setup_s = time.perf_counter() - t_start
    _timed_calls(cell, device, rec, seconds)
    rec.work = cell.work(len(rec.calls))
    rec.call_work = cell.work(1)
    if traced:
        _traced(cell, rec)
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    print(json.dumps({"counters": cell.counters(), "calls": len(rec.calls),
                      "window_s": rec.window_s}), flush=True)
    cell.free()
    t_check = time.perf_counter()
    numbers = cell.check()
    info = dict(getattr(cell, "check_info", {}),
                check_s=time.perf_counter() - t_check)
    print(json.dumps({"check_info": info}), file=sys.stderr, flush=True)
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}
    missing = sorted(set(limits) - set(numbers))
    correct = not missing and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        reader = load_module(os.path.join(HERE, "metrics",
                                          m["name"] + ".py"),
                             "lpcbench_metric_" + m["name"])
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_line = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell_entry["chips"],
                "memory_peak_bytes": memory}
    result = {"correct": correct, "attempted": len(rec.calls), "failed": 0,
              "metrics": metrics, "device": dev_line}
    if traced:
        dev_line["busy_s"] = rec.trace.busy_us() * 1e-6
        dev_line["window_s"] = rec.traced_s
        result["breakdown"] = {"device_ops": rec.trace.top_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    if missing:
        checks["missing"] = {"value": len(missing), "limit": 0}
    result["checks"] = checks
    return result


def _merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def report(result: Dict[str, Any]) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output; no result
    where a module of JAX or the JAX package is loaded by then (by the
    port, the reference or a metric's reader)."""
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{bad}")
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)

