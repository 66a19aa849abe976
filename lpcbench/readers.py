"""What the metric files under metrics/ share: each file names its layer
and its kernels and reads one number from a harness.Run; a reader that
finds nothing to read returns None, and the metric is left out of the
line."""
from typing import Optional, Sequence

from . import flops

# the __global__ entry points of the port's hand-written sample kernels
# (the plan-L and plan-T instances of csrc/sample_loop.cuh)
SAMPLE_KERNELS = ("sample_l_kernel", "sample_t_kernel")


def _matches(names: Sequence[str]):
    return lambda n: any(k in n for k in names)


def kernel_s(run, names: Sequence[str]) -> float:
    """Traced device seconds of the kernels whose names hold one of
    `names`."""
    return run.trace.busy_us(_matches(names)) * 1e-6


def roofline_pct(run, names: Sequence[str]) -> Optional[float]:
    """The sample loop's least time on the card (its operations over the
    float32 peak, or its bytes over HBM bandwidth, whichever is larger)
    over the traced time of its kernels, in percent."""
    if run.trace is None:
        return None
    t = kernel_s(run, names)
    if t <= 0.0:
        return None
    least = flops.least_seconds(run.call_work["sample_loop"])["seconds"]
    return 100.0 * least * run.traced_calls / t


def mfu_pct(run) -> Optional[float]:
    """The model's operations over the window's wall time, as a share of
    the float32 peak, in percent."""
    if not run.window_s:
        return None
    return (100.0 * run.work["model_flops"] / run.window_s
            / flops.PEAKS["fp32_flops"])


def idle_pct(run) -> Optional[float]:
    """The device's idle share of a call: 1 - its traced busy time over
    the mean untraced wall time of a window call, in percent."""
    if run.trace is None or not run.trace.device:
        return None
    busy = run.trace.busy_us() * 1e-6 / run.traced_calls
    return 100.0 * (1.0 - busy / run.untraced_call_s())


def busy_ms_per_call(run, exclude: Sequence[str] = ()) -> Optional[float]:
    """Traced device ms per call of the kernels outside `exclude`."""
    if run.trace is None or not run.trace.device:
        return None
    us = run.trace.busy_us(lambda n: not _matches(exclude)(n))
    return us * 1e-3 / run.traced_calls
