"""replay_host_ms_p95.frame: the 95th percentile of the host ms of the
untraced graph replays of the run's entry point (copy_in + launch +
clone_out: the arguments' copies into the graph, graph.replay() and the
clones of its outputs), over the newest replays that
lpcnet_tpu_torch.utils.profiling kept (REPLAY_RECORD, 32768: at 30 s
every replay of the window, and the set-up's few). None where it kept
fewer than two: on the CPU, and in a program without the record."""
import statistics

from lpcnet_tpu_torch.utils import profiling

LAYER = "entry point"


def read(run):
    host_ms = getattr(profiling, "replay_host_ms", None)
    ms = host_ms() if host_ms is not None else []
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
