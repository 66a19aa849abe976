"""non_sample_device_ms.frame: traced device ms per call of every kernel
but the sample kernels: the conditioning and, in PLC, its front end."""
from lpcbench import readers

LAYER = "conditioning and PLC front end"
KERNELS = readers.SAMPLE_KERNELS


def read(run):
    return readers.busy_ms_per_call(run, exclude=KERNELS)
