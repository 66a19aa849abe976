"""Driver of DRED's streaming sender: DREDCodec.step, closed loop.

The traffic mix gives "streams", "dframes_per_call", the feature file
("features", (N, 36) float32 frames under lpcbench/, of which the encoder
takes the first 20), "setup_dframes" (calls before the window: at least a
payload's num_dframes, so every timed call sends a full payload) and
"check" ({"streams": s, "calls": c}). Every stream reads the feature
file in a loop from its own offset, drawn from the seed, so every seed
has the same sizes. Each call advances every stream by dframes_per_call
dframes (4 feature frames of 10 ms each) from the state the last call
left; the state stays on the device between calls, where the step
updates it in place.

The weights are drawn from the seed by the reference's draw_params
("weights": "drawn"), never by the program: every bias nonzero, a scale
and a dead zone of its own for every latent at every lambda level. The
program and the reference are fed the same tree. The check: the plain
reference (reference/rdovae_encode.py) encodes the whole history of s
streams drawn from the seed, from the first set-up call to the last
window call, from zero state, and compares
what the window's last c calls sent: latent_gap (the widest gap of a
latent over the larger of 1 and the reference's largest), pvq_off (PVQ
states, the dframe's and its payload's oldest, that differ by more than
PVQ_TOL in an entry), sym_gap (the farthest that the reference's
unrounded payload symbol lies outside the rounding interval of the
program's symbol: a rounding tie moves a symbol at no cost, a wrong one
costs 0.5 or more) and calls_unchecked.

With ctx["control"] the program runs with TF32 allowed in its products,
the nearest precision below the configuration's float32 on the card:
setup() sets torch.backends.cuda.matmul.allow_tf32 and goes around the
encoder's refuse_tf32 until free(); the reference runs in float32 all
the same.
"""
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from lpcbench import rdovae_flops
from lpcbench.reference import rdovae_encode as ref

FRAMES_PER_DFRAME = 4
FRAME_S = 0.01
# a PVQ state is a unit vector of 82 integer pulses: one pulse moved
# changes an entry by 1/82 or more; the same pulses agree within 1e-6
PVQ_TOL = 1e-4


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


class DREDCell:
    traced_calls = 20
    sample_kernels = ()

    def __init__(self, ctx):
        from lpcnet_tpu_torch import dred
        from lpcnet_tpu_torch.models import rdovae as rv
        from lpcnet_tpu_torch.utils import graphs, profiling
        if not hasattr(dred.DREDCodec, "step"):
            raise SystemExit("this program has no streaming DRED encoder "
                             "(DREDCodec.step)")
        self._graphs, self._profiling = graphs, profiling
        cfgf, tr, dev = ctx["config"], ctx["traffic"], ctx["device"]
        self.device, self.sizes = dev, cfgf["rdovae"]
        self.dred_cfg = cfgf["dred"]
        self.B, self.D = tr["streams"], tr["dframes_per_call"]
        self.traced_calls = tr.get("traced_calls", self.traced_calls)
        rs = np.random.default_rng(ctx["seed"])
        cfg = rv.RDOVAEConfig(**self.sizes)
        if cfgf["weights"] != "drawn":
            raise ValueError("rdovae-dred draws its weights (\"drawn\")")
        params = ref.draw_params(ctx["seed"], self.sizes)
        self.ref_params = _tree(params, lambda x: x.to(dev, copy=True))
        self._control = ctx["control"] and dev.type == "cuda"
        if self._control:
            self._refuse = rv.refuse_tf32
            rv.refuse_tf32 = lambda x, what: None
            torch.backends.cuda.matmul.allow_tf32 = True
        self.codec = dred.DREDCodec(params, cfg,
                                    dred.DREDConfig(**self.dred_cfg),
                                    device=dev)
        feats = np.fromfile(os.path.join(ctx["root"], "lpcbench",
                                         tr["features"]), np.float32)
        feats = feats.reshape(-1, 36)[:, :self.sizes["nb_features"]]
        self.feats = torch.as_tensor(np.ascontiguousarray(feats), device=dev)
        n = self.feats.shape[0]
        per_call = FRAMES_PER_DFRAME * self.D
        period = n // int(np.gcd(n, per_call))
        self.off = torch.as_tensor(rs.integers(0, n, self.B), device=dev)
        steps = torch.arange(per_call, device=dev)
        # the features of call c are blocks[c % period]
        self.blocks = [self.feats[(self.off[:, None] + k * per_call + steps)
                                  % n] for k in range(period)]
        chk = tr["check"]
        self.rows = torch.as_tensor(np.sort(rs.choice(
            self.B, chk["streams"], replace=False)), device=dev)
        self.check_calls = chk["calls"]
        self.kept: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        self.calls = 0
        self.state = self.codec.init_state(self.B)
        # the warm-up: the eager call, the capture and the replays up to a
        # full payload (graphs.CAPTURE_CALL calls at least)
        for _ in range(max(tr["setup_dframes"] // self.D,
                           graphs.CAPTURE_CALL)):
            self.call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def call(self):
        feats = self.blocks[self.calls % len(self.blocks)]
        self.out = self.codec.step(self.state, feats)
        self.calls += 1
        # the card is busy with the call: drop the outputs that fell out
        # of the check's last calls here, not between calls
        if len(self.kept) > self.check_calls:
            del self.kept[0]

    def keep(self, i: int, t: float) -> None:
        # the outputs of the window's last calls, by reference: each call
        # returns new tensors, and nothing runs on the device here
        self.kept.append((self.calls - 1, self.out))

    def work(self, n: int) -> Dict[str, Any]:
        dframes = n * self.B * self.D
        frames = dframes * FRAMES_PER_DFRAME
        gemm = rdovae_flops.encoder_work(self.sizes, self.B, n * self.D)
        return {"frames": frames, "audio_s": frames * FRAME_S,
                "dframes": dframes, "model_flops": gemm["flops"],
                "dred_gemm": gemm}

    def counters(self) -> Dict[str, Any]:
        g = self._graphs
        counted = getattr(self._profiling, "counters", {})
        return {"captures": dict(g.captures), "replays": dict(g.replays),
                **{k: v for k, v in counted.items()
                   if k.startswith("dred.")}}

    def free(self) -> None:
        self.kept = [(c, {k: v[self.rows].clone() for k, v in out.items()})
                     for c, out in self.kept[-self.check_calls:]]
        del self.codec, self.state, self.out, self.blocks
        if self._control:
            from lpcnet_tpu_torch.models import rdovae as rv
            rv.refuse_tf32 = self._refuse
            torch.backends.cuda.matmul.allow_tf32 = False
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        d, dr = self.D, self.dred_cfg
        if not self.kept:
            return {"latent_gap": 0.0, "pvq_off": 0, "sym_gap": 0.0,
                    "calls_unchecked": self.check_calls}
        calls = self.kept[-1][0] + 1
        n = self.feats.shape[0]
        idx = (self.off[self.rows][:, None]
               + torch.arange(calls * d * FRAMES_PER_DFRAME,
                              device=self.device)) % n
        z, s = ref.encode(self.ref_params, self.feats[idx])
        at = [c * d + j for c, _ in self.kept for j in range(d)]
        ramp = (dr["num_dframes"], dr["q0"], dr["q1"])
        _, oldest = ref.payloads(self.ref_params, z, s, at, *ramp)
        values = ref.payload_values(self.ref_params, z, at, *ramp)

        def prog(key):
            return torch.cat([out[key] for _, out in self.kept], dim=1)
        zr = z[:, at]
        latent_gap = float((prog("latents") - zr).abs().max()) / max(
            1.0, float(zr.abs().max()))
        pvq = torch.stack([(prog("states") - s[:, at]).abs().amax(-1),
                           (prog("oldest_state") - oldest).abs().amax(-1)])
        # how far each of the reference's unrounded symbols lies outside
        # the rounding interval of the program's symbol: 0 where they
        # agree; a float32 rounding tie, ~1e-6 at most; a wrong symbol 0.5
        # or more
        outside = ((values - prog("symbols")).abs() - 0.5).clamp(min=0.0)
        self.check_info = {"history_dframes": calls * d,
                           "reference_s": time.perf_counter() - t0,
                           "pvq_widest_gap": float(pvq.max()),
                           "symbols_off": int((outside > 0).sum()),
                           "symbols_compared": values.numel()}
        return {"latent_gap": latent_gap,
                "pvq_off": int((pvq > PVQ_TOL).sum()),
                "sym_gap": float(outside.max()),
                "calls_unchecked": self.check_calls - len(self.kept)}


def setup(ctx) -> DREDCell:
    return DREDCell(ctx)
