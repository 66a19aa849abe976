"""Entry points of the one-frame synthesis step, compiled, and of the
multi-card dry run (the port of the JAX package's __graft_entry__.py).

    python -m lpcnet_tpu_torch.graft_entry [--device cuda|cpu]

entry() gives (fn, example_args): one 10-ms frame of batched synthesis at
LPCNetConfig() for 32 streams, frame_conditions then 160 sample steps (the
frame kernel on the card, the plain loop on the CPU). compile_step(fn,
args) (utils/graphs.py) is the counterpart of jax.jit(fn): one call of fn
captured as a CUDA graph, which replays the whole step with no host
dispatch inside it.
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
# compile_step lives in utils/graphs.py, beside the entry points' jit
from .utils.graphs import (WARMUP_CALLS, CompiledStep,  # noqa: F401
                           compile_step)
from .vocoder import Synthesizer

State = Dict[str, torch.Tensor]


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
