"""frame_ms_p95: the 95th percentile of the wall time of every call in
the window (each call gives one 10-ms frame per stream), ms."""


def read(run):
    return run.p(95)
