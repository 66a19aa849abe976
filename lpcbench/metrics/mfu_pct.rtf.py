"""mfu_pct.rtf: the model's operations per second over the window, as
a share of the card's float32 peak, percent."""
from lpcbench import readers

LAYER = "whole step"


def read(run):
    return readers.mfu_pct(run)
