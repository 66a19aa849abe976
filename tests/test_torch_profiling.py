"""The port's tracing and stage timing (lpcnet_tpu_torch/utils/
profiling.py): parse_trace_utilization on a hand-written chrome trace of
Kineto's event layout gives known numbers exactly; StageTimer's summary
has the JAX package's keys; trace() on the CPU writes a readable trace;
the sample kernels' names are those of the CUDA sources."""
import gzip
import json
import os
import re
import time

import pytest
import torch

from lpcnet_tpu.utils import profiling as j_prof
from lpcnet_tpu_torch.utils import profiling

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "lpcnet_tpu_torch",
                    "csrc")
# the names Kineto gives the kernels on the card
K_L = "void lpcnet::sample_l_kernel<0, true, false, false>(LpcnetFrameParams)"
K_T = "void lpcnet::sample_t_kernel<0, true, false, false>(LpcnetFrameParams)"


def _write_trace(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur}


def test_parse_trace_utilization_known_numbers(tmp_path):
    """Device events from 100 to 1100 us: a copy (100-150), a conditioning
    kernel (200-300), the sample kernel of plan T (400-900), one nested in
    it that is dropped from busy time (500-600), plan L's (950-1050), a
    memset (1090-1100); CPU events and a non-X event are ignored. Busy
    50 + 100 + 500 + 100 + 10 = 760 of a 1000-us span; the sample kernels
    500 + 100 (and the nested 100: duty counts every sample-kernel
    event) = 700."""
    evs = [_x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 100, 50),
           _x("void at::native::gemm_kernel<float>()", "kernel", 200, 100),
           _x(K_T, "kernel", 400, 500),
           _x(K_T, "kernel", 500, 100),
           _x(K_L, "kernel", 950, 100),
           _x("Memset (Device)", "gpu_memset", 1090, 10),
           _x("aten::mm", "cpu_op", 0, 5000),
           {"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "GPU 0"}},
           {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0}]
    path = str(tmp_path / "host.1.pt.trace.json.gz")
    _write_trace(path, evs)
    u = profiling.parse_trace_utilization(str(tmp_path))
    assert u == {
        "trace": "host.1.pt.trace.json.gz", "span_us": 1000.0,
        "busy_us": 760.0, "duty_cycle": 0.7, "device_occupancy": 0.76,
        "busy_us_by_class": {K_T: 500.0,
                             "void at::native::gemm_kernel<float>()": 100.0,
                             K_L: 100.0,
                             "Memcpy HtoD (Pageable -> Device)": 50.0,
                             "Memset (Device)": 10.0}}
    # the file itself, and the newest of several
    assert profiling.parse_trace_utilization(path) == u
    time.sleep(0.01)
    _write_trace(str(tmp_path / "later.pt.trace.json.gz"),
                 [_x(K_L, "kernel", 0, 10), _x("other", "kernel", 20, 10)])
    later = profiling.parse_trace_utilization(str(tmp_path))
    assert later["trace"] == "later.pt.trace.json.gz"
    assert later["span_us"] == 30.0 and later["device_occupancy"] == 0.6667
    assert later["duty_cycle"] == 0.3333


def test_parse_trace_without_device_events(tmp_path):
    assert profiling.parse_trace_utilization(str(tmp_path)) is None
    _write_trace(str(tmp_path / "cpu.pt.trace.json.gz"),
                 [_x("aten::mm", "cpu_op", 0, 10)])
    assert profiling.parse_trace_utilization(str(tmp_path)) is None


def test_sample_kernel_names_are_the_sources_entry_points():
    """SAMPLE_KERNELS are the __global__ functions of the CUDA sources,
    every one of them."""
    names = set()
    for f in os.listdir(CSRC):
        with open(os.path.join(CSRC, f)) as fh:
            names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds"
                                    r"__\([^)]*\)\s+)?(\w+)", fh.read()))
    assert names == set(profiling.SAMPLE_KERNELS)


def test_stage_timer_summary_has_the_jax_keys():
    """StageTimer.summary() has JAX's schema (total_s, count, mean_ms per
    stage); a CPU tensor or device as the fence waits for nothing."""
    ours, theirs = profiling.StageTimer(), j_prof.StageTimer()
    for t in (ours, theirs):
        with t.stage("a"):
            pass
        t.add("b", 0.5, n=2)
    with ours.stage("a", fence=torch.zeros(3)):
        pass
    with ours.stage("a", fence="cpu"):
        pass
    s, j = ours.summary(), theirs.summary()
    assert s.keys() == j.keys() == {"a", "b"}
    for k in s:
        assert s[k].keys() == j[k].keys()
    assert s["a"]["count"] == 3 and s["b"] == j["b"] == {
        "total_s": 0.5, "count": 2, "mean_ms": 250.0}
    assert json.loads(ours.report()) == s
    with pytest.raises(TypeError):
        with ours.stage("c", fence=3):
            pass


def test_trace_on_the_cpu_writes_a_readable_trace(tmp_path):
    """trace() writes one gzipped chrome trace that holds the operators
    run inside it (no device events on the CPU: the parse gives None);
    an empty log_dir traces nothing; a trace of the devices alone needs
    one."""
    d = str(tmp_path / "tr")
    with profiling.trace(d):
        x = torch.ones(64, 64)
        (x @ x).sum()
    path = profiling.newest_trace(d)
    assert path is not None and path.endswith(".pt.trace.json.gz")
    with gzip.open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in evs)
    assert profiling.parse_trace_utilization(d) is None
    with profiling.trace("") as prof:
        assert prof is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with profiling.trace(d, cpu=False):
                pass
