"""setup_s: seconds from the process's start to the first timed call
(loading, warm-up, the kernels' build where the checkout has none, the
first call of each shape and its CUDA graph's capture)."""


def read(run):
    return run.setup_s
