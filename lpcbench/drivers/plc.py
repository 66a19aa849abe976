"""Driver of causal packet-loss concealment: PLCEngine.step, closed loop.

The traffic mix gives "streams", the speech file ("pcm", int16 samples
under lpcbench/), the loss process ("loss": bursts of "burst" frames, 1 to
3 drawn uniformly, after runs of "good" received frames, drawn uniformly
from its range; the first "lead" frames are received) and "check"
({"calls": c}). Every stream plays the speech file in a loop from its own
offset, and every seed draws its own offsets and its own loss pattern
from one process, so every seed has the same sizes. Each call is one
10-ms frame of every stream, and the call's cost does not depend on which
frames are lost: the engine computes every path and selects per stream.

The check keeps the first call's output and state after (from the
program's fresh state, compared leaf by leaf with the reference's own)
and, for c consecutive window calls from a point drawn from the seed,
each call's state on entry, input, loss flags, output and state after.
The reference (reference/plc_step.py) runs each kept call from its state
on entry along the program's output and compares the state after
(state_gap: the median over the checked calls of a call's widest gap).

With ctx["control"] the reference itself, its products in bfloat16,
takes the program's place.
"""
import os
from typing import Any, Dict, List

import numpy as np
import torch

from lpcbench import flops
from lpcbench.drivers.synth import SAMPLE_KERNELS, lpcnet_params
from lpcbench.reference import compare, plc_step, sample_check, weights
from lpcbench.reference.frozen.models import lpcnet as ref_lpcnet
from lpcbench.reference.frozen.models import plc as ref_plc


def loss_pattern(rs: np.random.Generator, n: int, loss: Dict[str, Any]
                 ) -> np.ndarray:
    """n loss flags: `lead` received frames, then runs of received frames
    (lengths uniform over loss["good"]) and bursts of lost frames
    (uniform over loss["burst"]), alternately."""
    flags = np.zeros(n, bool)
    i = loss["lead"]
    while i < n:
        i += int(rs.integers(loss["good"][0], loss["good"][1] + 1))
        b = int(rs.integers(loss["burst"][0], loss["burst"][1] + 1))
        flags[i:i + b] = True
        i += b
    return flags


class _Control:
    """The reference in the program's place, its products in bfloat16."""

    def __init__(self, ref):
        self.ref = ref

    def init_state(self, n):
        return self.ref.fresh(n)

    def step(self, state, pcm, lost):
        with torch.autocast(pcm.device.type, dtype=torch.bfloat16):
            new, out, _ = self.ref.step(state, pcm, lost, None)
        return new, out


class _Reference:
    def __init__(self, lp, pp, sizes, plc_sizes):
        self.cfg = ref_lpcnet.LPCNetConfig(**sizes)
        self.plc_cfg = ref_plc.PLCConfig(**plc_sizes)
        self.lp, self.pp = lp, pp
        self.tb = sample_check.tables(lp, self.cfg)

    def fresh(self, n):
        dev = self.tb["wr_a"].device
        return plc_step.init_state(n, self.cfg, self.plc_cfg, dev)

    def step(self, state, pcm, lost, out):
        return plc_step.step(self.lp, self.pp, self.tb, self.cfg,
                             self.plc_cfg, state, pcm, lost, out)


class PLCCell:
    traced_calls = 50
    sample_kernels = SAMPLE_KERNELS

    def __init__(self, ctx):
        from lpcnet_tpu_torch.kernels import sample_cuda
        from lpcnet_tpu_torch.models import lpcnet, plc as plc_model
        from lpcnet_tpu_torch.plc import PLCEngine, PLCOptions
        from lpcnet_tpu_torch.utils import graphs
        self._graphs, self._sample_cuda = graphs, sample_cuda
        cfgf, tr, dev = ctx["config"], ctx["traffic"], ctx["device"]
        self.device = dev
        self.sizes, self.plc_sizes = cfgf["lpcnet"], cfgf["plc"]
        self.B = tr["streams"]
        self.traced_calls = tr.get("traced_calls", self.traced_calls)
        if dev.type != "cuda":
            self.sample_kernels = ()
        rs = np.random.default_rng(ctx["seed"])
        lp = lpcnet_params(ctx)
        if cfgf["plc_weights"] == "init":
            pp = weights.draw(weights.plc_spec(self.plc_sizes),
                              ctx["seed"] + 1, dev)
        else:
            pp = weights.to_torch(weights.read_tree(
                os.path.join(ctx["root"], cfgf["plc_weights"])), dev)
        self.ref = _Reference(weights.clone(lp), weights.clone(pp),
                              self.sizes, self.plc_sizes)
        if ctx["control"]:
            self.engine = _Control(_Reference(lp, pp, self.sizes,
                                              self.plc_sizes))
        else:
            self.engine = PLCEngine(
                lp, pp, lpcnet.LPCNetConfig(**self.sizes),
                plc_model.PLCConfig(**self.plc_sizes),
                options=PLCOptions(remove_dc=cfgf["remove_dc"]), device=dev)
        pcm = np.fromfile(os.path.join(ctx["root"], "lpcbench", tr["pcm"]),
                          np.int16).astype(np.float32)
        fs = self.sizes["frame_size"]
        frames = torch.as_tensor(pcm[:len(pcm) // fs * fs].reshape(-1, fs),
                                 device=dev)
        n = frames.shape[0]
        off = torch.as_tensor(rs.integers(0, n, self.B), device=dev)
        # call c plays frames (off + c) % n; its loss flags are lost[c]
        self.frames = [frames[(off + c) % n].contiguous() for c in range(n)]
        horizon = tr["loss_horizon"]
        self.lost = torch.as_tensor(np.stack(
            [loss_pattern(rs, horizon, tr["loss"]) for _ in range(self.B)],
            axis=1), device=dev)
        self.check_from = float(rs.uniform(0.1, 0.5)) * ctx["seconds"]
        self.check_calls = tr["check"]["calls"]
        self.kept: List[Dict[str, Any]] = []
        self.calls = 0
        self.state = self.engine.init_state(self.B)
        self.start_state = compare.rows(self.state, slice(None))
        for k in range(graphs.CAPTURE_CALL):
            state_in = self.state
            self._call()
            if k == 0:
                self.start = self._keep(state_in)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _call(self):
        c = self.calls
        self.pcm_in = self.frames[c % len(self.frames)]
        self.lost_in = self.lost[c % self.lost.shape[0]]
        self.state, self.out = self.engine.step(self.state, self.pcm_in,
                                                self.lost_in)
        self.calls += 1

    def _keep(self, state_in) -> Dict[str, Any]:
        every = slice(None)
        return {"state_in": compare.rows(state_in, every),
                "pcm": self.pcm_in.clone(), "lost": self.lost_in.clone(),
                "out": self.out.clone(),
                "state_out": compare.rows(self.state, every)}

    def call(self):
        self._state_in = self.state
        self._call()

    def keep(self, i: int, t: float) -> None:
        if len(self.kept) < self.check_calls and (self.kept
                                                  or t >= self.check_from):
            self.kept.append(self._keep(self._state_in))

    def work(self, n: int) -> Dict[str, Any]:
        s = self.sizes
        frames = n * self.B
        return {"frames": frames,
                "audio_s": frames * s["frame_size"] / 16000.0,
                "samples": frames * s["frame_size"],
                "model_flops": frames * (
                    s["frame_size"] * flops.sample_flops(s)
                    + flops.frame_flops(s)
                    + flops.plc_flops(self.plc_sizes, s["nb_features"])),
                "sample_loop": flops.sample_loop_work(s, self.B, n)}

    def counters(self) -> Dict[str, Any]:
        g = self._graphs
        return {"captures": dict(g.captures), "replays": dict(g.replays),
                "launches": {k: v for k, v in
                             self._sample_cuda.launches.items() if v},
                "plan_launches": dict(self._sample_cuda.plan_launches),
                "lost_frames_kept": int(sum(int(k["lost"].sum())
                                            for k in self.kept))}

    def free(self) -> None:
        del self.engine, self.state, self.out, self.frames
        self._state_in = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        own = self.ref.fresh(self.B)
        start_off = compare.rows_differ(own, self.start_state)
        segs = [dict(self.start, state_in=own)] + self.kept
        new, _, stats = self.ref.step(
            compare.cat([s["state_in"] for s in segs]),
            torch.cat([s["pcm"] for s in segs]),
            torch.cat([s["lost"] for s in segs]),
            torch.cat([s["out"] for s in segs]))
        gaps, int_off, leaf = compare.state_gaps(
            new, compare.cat([s["state_out"] for s in segs]))
        self.check_info = {"state_gap_widest_row": float(gaps.max()),
                           "leaf": leaf}
        return {"tree_gap": stats["tree_gap"],
                "state_gap": float(gaps.median()),
                "pcm_off": stats["pcm_off"], "int_off": int_off,
                "start_off": start_off,
                "calls_unchecked": self.check_calls - len(self.kept)}


def setup(ctx) -> PLCCell:
    return PLCCell(ctx)
