"""device_idle_pct.frame: 1 - traced device busy time per call over the
untraced wall time of a window call, percent."""
from lpcbench import readers

LAYER = "device"


def read(run):
    return readers.idle_pct(run)
