"""Driver of LPCNet synthesis: Synthesizer.synthesize, closed loop.

The traffic mix gives "streams" (the batch), "frames_per_call", the
feature file ("features", (N, 36) float32 frames under lpcbench/) and
"check" ({"streams": s, "calls": c}). Every stream reads the feature file
in a loop from its own offset, drawn from the seed, so every seed has the
same sizes; the streams' RNGs are seeded one per stream. Each call
synthesizes frames_per_call frames of every stream, going on from the
state the last call returned.

What the check keeps: the program's state on entry to the first call
(the start) and its first call's output and state, for s streams drawn
from the seed; and for c consecutive window calls from a point drawn from
the seed, each call's state on entry, output and state after, for those s
streams. The reference (reference/sample_check.py) takes the start from
its own fresh state and each window call from the program's state on
entry, computes each call's conditioning over the whole batch as the
call did, runs the sample loop along the program's output over every
frame of the call, and compares the state after: the RNG and the last
excitation exactly, the GRU states and the signal history by state_gap
(the median over the checked rows of a row's widest gap).
"""
import os
from typing import Any, Dict, List

import numpy as np
import torch

from lpcbench import flops
from lpcbench.reference import compare, sample_check, weights
from lpcbench.reference.frozen.models import lpcnet as ref_lpcnet

SAMPLE_KERNELS = ("sample_l_kernel", "sample_t_kernel")


def lpcnet_params(ctx) -> Dict[str, Any]:
    """The parameter tree the configuration names, on the device: a
    shipped checkpoint under the checkout, or "init" (drawn from the
    seed)."""
    cfg = ctx["config"]
    if cfg["weights"] == "init":
        return weights.draw(weights.lpcnet_spec(cfg["lpcnet"]), ctx["seed"],
                            ctx["device"])
    return weights.to_torch(weights.read_tree(
        os.path.join(ctx["root"], cfg["weights"])), ctx["device"])


class SynthCell:
    traced_calls = 3

    def __init__(self, ctx):
        from lpcnet_tpu_torch.kernels import sample_cuda
        from lpcnet_tpu_torch.models import lpcnet
        from lpcnet_tpu_torch.utils import graphs
        from lpcnet_tpu_torch.vocoder import Synthesizer
        self._graphs, self._sample_cuda = graphs, sample_cuda
        tr, dev = ctx["traffic"], ctx["device"]
        self.device, self.sizes = dev, ctx["config"]["lpcnet"]
        self.B, self.F = tr["streams"], tr["frames_per_call"]
        self.traced_calls = tr.get("traced_calls", self.traced_calls)
        self.sample_kernels = SAMPLE_KERNELS if dev.type == "cuda" else ()
        rs = np.random.default_rng(ctx["seed"])
        params = lpcnet_params(ctx)
        self.ref_params = weights.clone(params)
        self.voc = Synthesizer(lpcnet.LPCNetConfig(**self.sizes),
                               params=params, device=dev,
                               tables="bf16" if ctx["control"] else "f32")
        feats = np.fromfile(os.path.join(ctx["root"], "lpcbench",
                                         tr["features"]), np.float32)
        feats = torch.as_tensor(feats.reshape(-1, 36), device=dev)
        n = feats.shape[0]
        period = n // int(np.gcd(n, self.F))
        off = torch.as_tensor(rs.integers(0, n, self.B), device=dev)
        steps = torch.arange(self.F, device=dev)
        # the features of call c are blocks[c % period]
        self.blocks = [feats[(off[:, None] + k * self.F + steps) % n]
                       for k in range(period)]
        chk = tr["check"]
        self.rows = torch.as_tensor(np.sort(rs.choice(
            self.B, chk["streams"], replace=False)), device=dev)
        self.check_from = float(rs.uniform(0.1, 0.5)) * ctx["seconds"]
        self.check_calls = chk["calls"]
        self.kept: List[Dict[str, Any]] = []
        self.calls = 0
        self.state = self.voc.reset(self.B, per_stream_rng=True)
        self.start_state = compare.rows(self.state, self.rows)
        # the warm-up: the eager call and the capture (graphs.CAPTURE_CALL
        # calls), the first kept for the check of the start
        for k in range(graphs.CAPTURE_CALL):
            state_in = self.state
            self._call()
            if k == 0:
                self.start = self._keep(state_in)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _call(self):
        feats = self.blocks[self.calls % len(self.blocks)]
        self.state, self.out = self.voc.synthesize(self.state, feats)
        self.calls += 1

    def _keep(self, state_in) -> Dict[str, Any]:
        return {"state_in": compare.rows(state_in, self.rows),
                "call": self.calls - 1,
                "out": self.out[self.rows].clone(),
                "state_out": compare.rows(self.state, self.rows)}

    def call(self):
        self._state_in = self.state
        self._call()

    def keep(self, i: int, t: float) -> None:
        if len(self.kept) < self.check_calls and (self.kept
                                                  or t >= self.check_from):
            self.kept.append(self._keep(self._state_in))

    def work(self, n: int) -> Dict[str, Any]:
        s = self.sizes
        frames = n * self.B * self.F
        return {"frames": frames,
                "audio_s": frames * s["frame_size"] / 16000.0,
                "samples": frames * s["frame_size"],
                "model_flops": frames * (s["frame_size"]
                                         * flops.sample_flops(s)
                                         + flops.frame_flops(s)),
                "sample_loop": flops.sample_loop_work(s, self.B,
                                                      n * self.F)}

    def counters(self) -> Dict[str, Any]:
        g = self._graphs
        return {"captures": dict(g.captures), "replays": dict(g.replays),
                "launches": {k: v for k, v in
                             self._sample_cuda.launches.items() if v},
                "plan_launches": dict(self._sample_cuda.plan_launches)}

    def free(self) -> None:
        del self.voc, self.state, self.out
        self._state_in = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        cfg = ref_lpcnet.LPCNetConfig(**self.sizes)
        tb = sample_check.tables(self.ref_params, cfg)
        own = sample_check.init_state(self.B, cfg, self.device)
        own = compare.rows(own, self.rows)
        start_off = compare.rows_differ(own, self.start_state)
        segs = [dict(self.start, state_in=own)] + self.kept
        # each call's conditioning over the whole batch, as the call made
        # it: the LPC enters the prediction, which is quantized
        parts = [ref_lpcnet.frame_conditions(
            self.ref_params, self.blocks[s["call"] % len(self.blocks)], cfg,
            tb) for s in segs]
        conds = {k: torch.cat([c[k][self.rows] for c in parts])
                 for k in ("cond_a", "cond_b", "lpc")}
        state_in = compare.cat([s["state_in"] for s in segs])
        state_out, _, stats = sample_check.follow(
            tb, cfg, state_in, conds, torch.cat([s["out"] for s in segs]))
        gaps, int_off, leaf = compare.state_gaps(
            state_out, compare.cat([s["state_out"] for s in segs]))
        numbers = {"tree_gap": stats["tree_gap"], "pcm_off": stats["pcm_off"],
                   "state_gap": float(gaps.median()), "int_off": int_off,
                   "start_off": start_off,
                   "calls_unchecked": self.check_calls - len(self.kept)}
        self.check_info = {"state_gap_widest_row": float(gaps.max()),
                           "leaf": leaf}
        return numbers


def setup(ctx) -> SynthCell:
    return SynthCell(ctx)
