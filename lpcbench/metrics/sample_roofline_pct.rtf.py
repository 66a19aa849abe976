"""sample_roofline_pct.rtf: the sample loop's least time on the card over
the traced time of the sample kernels, percent."""
from lpcbench import readers

LAYER = "kernel"
KERNELS = readers.SAMPLE_KERNELS


def read(run):
    return readers.roofline_pct(run, KERNELS)
