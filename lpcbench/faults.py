"""Faults planted in the program, to show that the check catches them.

    with plant("unchanged"): harness.run(...)

Each fault wraps one entry point of the port for the duration of the
block:
  unchanged  the call returns the state it was given (synthesis, PLC);
  token      one output sample of every stream is moved by 3 where the
             call produces it (synthesis, PLC);
  half       synthesis runs the first half of the streams and leaves the
             rest silent with their state as it was.
The exchange between cards is no fault of these cells: each runs on one.
"""
import contextlib
from typing import Iterator

import torch

FAULTS = ("unchanged", "token", "half")
TOKEN_AT, TOKEN_BY = 37, 3.0


def _moved(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[:, TOKEN_AT] += TOKEN_BY
    return out


def _synth(fault, orig):
    def synthesize(self, state, features):
        if fault == "half":
            h = features.shape[0] // 2
            new, pcm = orig(self, {k: v[:h] for k, v in state.items()},
                            features[:h])
            new = {k: torch.cat([new[k], v[h:]]) for k, v in state.items()}
            pad = torch.zeros((features.shape[0] - h,) + pcm.shape[1:],
                              dtype=pcm.dtype, device=pcm.device)
            return new, torch.cat([pcm, pad])
        new, pcm = orig(self, state, features)
        return (state, pcm) if fault == "unchanged" else (new, _moved(pcm))
    return synthesize


def _plc(fault, orig):
    def step(self, state, pcm, lost):
        new, out = orig(self, state, pcm, lost)
        return (state, out) if fault == "unchanged" else (new, _moved(out))
    return step


@contextlib.contextmanager
def plant(fault: str) -> Iterator[None]:
    """The port with `fault` planted while the block runs."""
    from lpcnet_tpu_torch import plc, vocoder
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    saved = [(vocoder.Synthesizer, "synthesize"), (plc.PLCEngine, "step")]
    old = [getattr(o, n) for o, n in saved]
    if fault in ("unchanged", "token", "half"):
        vocoder.Synthesizer.synthesize = _synth(fault, old[0])
    if fault in ("unchanged", "token"):
        plc.PLCEngine.step = _plc(fault, old[1])
    try:
        yield
    finally:
        for (o, n), v in zip(saved, old):
            setattr(o, n, v)
