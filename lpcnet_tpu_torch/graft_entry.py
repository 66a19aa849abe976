"""Entry points of the one-frame synthesis step, compiled, and of the
multi-card dry run (the port of the JAX package's __graft_entry__.py).

    python -m lpcnet_tpu_torch.graft_entry [--device cuda|cpu]

entry() gives (fn, example_args): one 10-ms frame of batched synthesis at
LPCNetConfig() for 32 streams, frame_conditions then 160 sample steps (the
frame kernel on the card, the plain loop on the CPU). compile_step(fn,
args) is the counterpart of jax.jit(fn): one call of fn captured as a CUDA
graph, which replays the whole step with no host dispatch inside it.
dryrun_multichip(n) runs the data-parallel training step and stream-
parallel synthesis over n ranks (parallel/mesh.py).
"""
import argparse
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .constants import NB_TOTAL_FEATURES
from .kernels import sample_cuda
from .models import lpcnet
from .parallel import mesh
from .vocoder import Synthesizer

State = Dict[str, torch.Tensor]
WARMUP_CALLS = 2     # eager calls of fn before its capture


def entry(device=None, batch: int = 32,
          params: Optional[Dict[str, Any]] = None
          ) -> Tuple[Callable, Tuple[State, torch.Tensor]]:
    """(fn, example_args): fn(state, feats) -> (new_state, pcm (B, T*160))
    synthesizes feats (B, T, 36) from state with Synthesizer(device=device,
    params=params) (None: the shipped weights on the card; it raises where
    there is none). example_args are a fresh reset's state and zero
    features of one frame, (batch, 1, 36), as the JAX entry builds them."""
    voc = Synthesizer(device=device, params=params)
    state = voc.reset(batch)
    feats = torch.zeros((batch, 1, NB_TOTAL_FEATURES), dtype=torch.float32,
                        device=voc.device)

    @torch.no_grad()
    def fn(state, feats):
        conds = lpcnet.frame_conditions(voc.params, feats, voc.cfg,
                                        voc.tables)
        return sample_cuda.synthesize_frames(voc.frame_tables, state, conds,
                                             voc.cfg, variant=voc.variant)

    return fn, (state, feats)


class CompiledStep:
    """A captured call of fn: step(state, feats) copies its arguments into
    the graph's static inputs, replays the graph and returns clones of its
    outputs. `replays` counts the replays; the kernels' own launch counters
    ticked in compile_step's warm-up and capture, and never in a replay."""

    def __init__(self, graph: torch.cuda.CUDAGraph, state: State,
                 feats: torch.Tensor, out: Tuple[State, torch.Tensor]):
        self.graph, self.state, self.feats, self.out = graph, state, feats, out
        self.replays = 0

    def __call__(self, state: State, feats: torch.Tensor
                 ) -> Tuple[State, torch.Tensor]:
        if state.keys() != self.state.keys() or any(
                state[k].shape != v.shape for k, v in self.state.items()) \
                or feats.shape != self.feats.shape:
            raise ValueError("a compiled step takes arguments of the shapes "
                             "it was captured with")
        for k, v in self.state.items():
            v.copy_(state[k])
        self.feats.copy_(feats)
        self.graph.replay()
        self.replays += 1
        new, pcm = self.out
        return {k: v.clone() for k, v in new.items()}, pcm.clone()


def compile_step(fn: Callable, example_args: Tuple[State, torch.Tensor]
                 ) -> CompiledStep:
    """The counterpart of jax.jit(fn) on the card: fn warmed up on a side
    stream (cuBLAS handles, cuFFT plans, the kernels' libraries and
    per-device constants exist before the capture), then one call of fn on
    static copies of example_args captured in a torch.cuda.CUDAGraph.
    Raises RuntimeError on a device that is not CUDA (there are no graphs
    there) and when the capture fails; it never falls back to eager
    calls."""
    state, feats = example_args
    dev = feats.device
    if dev.type != "cuda":
        raise RuntimeError(f"compile_step captures a CUDA graph; the "
                           f"arguments are on {dev}")
    static_state = {k: v.clone() for k, v in state.items()}
    static_feats = feats.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            fn(static_state, static_feats)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn(static_state, static_feats)
    except Exception as e:
        raise RuntimeError(f"compile_step: the step could not be captured "
                           f"as a CUDA graph: {e}") from e
    return CompiledStep(graph, static_state, static_feats, out)


def dryrun_multichip(n: int, device=None) -> Dict[str, Any]:
    """Both distribution axes over n ranks at LPCNetConfig(): the
    data-parallel training step (mesh.dryrun_training_step), then
    stream-parallel synthesis (mesh.dryrun_inference_stream_dp); each
    raises RuntimeError on a failed check. device None: rank r on cuda:r
    (NCCL); a CPU device: gloo. Returns each one's per-rank results."""
    train = mesh.dryrun_training_step(n, device=device)
    infer = mesh.dryrun_inference_stream_dp(n, device=device)
    return {"train": train, "inference": infer}


def same_output(a: Tuple[State, torch.Tensor],
                b: Tuple[State, torch.Tensor]) -> bool:
    """Two (state, pcm) results of the step are bit-identical: pcm and
    every state leaf."""
    return torch.equal(a[1], b[1]) and all(
        torch.equal(v, b[0][k]) for k, v in a[0].items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): the step captured as a CUDA graph "
                         "and replayed, held bit-identical to an eager "
                         "call; cpu: the step called eagerly")
    dev = torch.device(ap.parse_args(argv).device)
    fn, args = entry(device=dev)
    eager = fn(*args)
    if dev.type == "cuda":
        step = compile_step(fn, args)
        if not same_output(step(*args), eager):
            raise RuntimeError("the replayed step differs from an eager "
                               "call on the same arguments")
        how = "captured as a CUDA graph, replay bit-identical to eager"
        n, rank_dev = torch.cuda.device_count(), None
    else:
        how = "called eagerly on the CPU, which has no CUDA graphs"
        n, rank_dev = 1, dev
    pcm = eager[1]
    print(f"entry OK: pcm {tuple(pcm.shape)}, finite "
          f"{bool(torch.isfinite(pcm).all())}; {how}")
    dryrun_multichip(n, device=rank_dev)
    print("dryrun_multichip OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
