"""dred_heads_span_ms.rtf: device ms a replay spent in the span
`dred_heads` (DREDCodec.step: the causal conv's latent, the state head
and PVQ, models/rdovae.encode_heads and pvq_quantize), from
lpcnet_tpu_torch.utils.profiling: the span's timing events, captured in
the entry point's CUDA graph, read at the start of the call after every
SPAN_READ_EVERY-th untraced replay (64: of the window's, and the
set-up's few) and after the window's last, whose events have completed
by then since the harness synchronises every call; the mean of those
reads. Traced replays, which CUPTI stretches, are not read. None where
no span was read: on the CPU, and in a program without spans."""
from lpcnet_tpu_torch.utils import profiling

LAYER = "DRED encoder"


def read(run):
    per_call = getattr(profiling, "span_ms_per_call", None)
    return None if per_call is None else per_call("dred_heads")
