"""audio_rtf: seconds of audio that all streams got in the window, over
the window's wall time."""


def read(run):
    return run.work["audio_s"] / run.window_s
