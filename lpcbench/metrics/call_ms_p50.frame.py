"""call_ms_p50.frame: the median wall time of a window call, ms."""
LAYER = "entry point"


def read(run):
    return run.p(50)
