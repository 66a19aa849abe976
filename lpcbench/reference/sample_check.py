"""The 16 kHz sample loop of LPCNet in plain PyTorch, run along the
program's own output.

The program samples each excitation from a tree of 256 sigmoid nodes with
thresholds drawn from a KISS99 generator (the reference C engine's
sample_mdense, nnet.c:163-214; lpcnet.c:235-271). A reference that samples
on its own would part from the program at the first near-tie its
rounding decides otherwise, and compare nothing after it. So `follow`
runs the loop teacher-forced on the program's samples, as a served model's
tokens are checked: at each step it computes, in float32 with ordinary
matrix products, the LPC prediction, the two GRUs, the dual FC's 256
logits and the step's 8 thresholds, finds the excitation that gives the
program's output sample, and measures by how much that excitation's path
through the tree lies on the wrong side of a threshold (0 where the walk
under the reference's logits takes it). It then feeds that excitation on.

Per checked row it returns the reference's state after the segment, and
over all rows:
  tree_gap  the widest such violation, in logit units;
  pcm_off   the samples that no excitation explains (an output more than
            one unit from every output the step can give), and forced
            samples whose output is not their target.
With out=None the loop samples on its own (the reference in the program's
place).
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .frozen.constants import LPC_ORDER
from .frozen.models import layers
from .frozen.models.lpcnet import precompute_sample_tables
from .frozen.ops import kiss99
from .frozen.ops.mulaw import ULAW2LIN_TABLE, lin2ulaw
from .frozen.ops.tables import SAMPLING_LOGIT_TABLE


def tables(params, cfg) -> Dict[str, torch.Tensor]:
    """The sample loop's tables, worked out from the parameters."""
    return precompute_sample_tables(params, cfg)


def stream_seeds(n: int) -> np.ndarray:
    """(n, 4) KISS99 states: stream i seeded with b"LPCNet" + i as 4
    little-endian bytes, the per-stream seeding of a batch of streams."""
    return np.stack([kiss99.seed_from_bytes(b"LPCNet" + i.to_bytes(4,
                                                                   "little"))
                     for i in range(n)])


def init_state(n: int, cfg, device, per_stream: bool = True
               ) -> Dict[str, torch.Tensor]:
    """The state of n fresh streams (lpcnet_reset, lpcnet.c:174-182),
    their RNGs seeded one per stream, or all with the reference's seed
    b"LPCNet" (lpcnet.c:176)."""
    seeds = (stream_seeds(n) if per_stream else
             np.tile(kiss99.seed_from_bytes(b"LPCNet"), (n, 1)))
    f32 = dict(dtype=torch.float32, device=device)
    return {"gru_a": torch.zeros((n, cfg.gru_a_units), **f32),
            "gru_b": torch.zeros((n, cfg.gru_b_units), **f32),
            "last_sig": torch.zeros((n, LPC_ORDER), **f32),
            "last_exc": torch.full((n,), 128, dtype=torch.int32,
                                   device=device),
            "deemph": torch.zeros((n,), **f32),
            "rng": kiss99.to_tensor(seeds, device)}


def _thresholds(rng: torch.Tensor, logit_tbl: torch.Tensor):
    rng, r1 = kiss99.kiss99_next(rng)
    rng, r2 = kiss99.kiss99_next(rng)
    byts = torch.stack([(r >> (8 * k)) & 0xFF for r in (r1, r2)
                        for k in range(4)], dim=-1)
    return logit_tbl[byts], rng


def _lpc_pred(sig: torch.Tensor, lpc: torch.Tensor) -> torch.Tensor:
    """-sum_k sig[k] lpc[k], added from k = 0 up as the C engine's loop
    does (lpcnet.c:252). The prediction is quantized to a mu-law index
    each step, so a prediction summed in another order would cross an
    index boundary now and then where the program's does not."""
    prod = sig * lpc
    acc = prod[:, 0]
    for k in range(1, prod.shape[-1]):
        acc = acc + prod[:, k]
    return -acc


def _node(exc: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heap node at level b on the path to leaf exc, and the bit taken."""
    return (1 << b) + (exc >> (8 - b)), (exc >> (7 - b)) & 1


# steps run eagerly before the one step's CUDA graph is captured (the
# first calls of cuBLAS set up its handle and workspace)
WARM_STEPS = 2


@torch.no_grad()
def follow(tb: Dict[str, torch.Tensor], cfg, state: Dict[str, torch.Tensor],
           conds: Dict[str, torch.Tensor], out: Optional[torch.Tensor],
           target: Optional[torch.Tensor] = None,
           forced: Optional[torch.Tensor] = None,
           tol: Optional[torch.Tensor] = None):
    """Run the loop over T frames for R rows.

    state: the rows' state before the segment; conds: cond_a (R, T, 3Na),
    cond_b (R, T, 3Nb), lpc (R, T, 16); out: the program's output (R,
    T*frame_size), or None to sample; target, forced (R, T*frame_size):
    where forced is set the step follows target, as teacher forcing
    does (lpcnet.c:256-261). tol (R, T*frame_size): how far an output
    may lie from the output of the excitation that explains it (default
    1: the rounding of the de-emphasis); where it is wider the loop
    prefers its own excitation when that one lies within it. Returns
    (state after, output (R,
    T*frame_size), {"tree_gap": float, "pcm_off": int}).

    One sample step reads its position from a counter on the device and
    updates the loop's buffers in place. On the CPU it runs T*frame_size
    times; on a card it runs WARM_STEPS times, then as a CUDA graph of
    the same operations, replayed for the rest: the same arithmetic,
    without a host launch per operation (a whole 50-frame call is 8000
    steps of some 300 small operations)."""
    dev = state["rng"].device
    u2l = torch.as_tensor(ULAW2LIN_TABLE, device=dev)
    logit_tbl = torch.as_tensor(SAMPLING_LOGIT_TABLE, device=dev)
    dfc = tb["dual_fc"]
    pre = cfg.preemph
    R, T = conds["cond_a"].shape[:2]
    fs = cfg.frame_size
    n = T * fs
    st = {"gru_a": state["gru_a"].clone(), "gru_b": state["gru_b"].clone(),
          "last_sig": state["last_sig"].clone(),
          "exc": state["last_exc"].to(torch.int64, copy=True),
          "deemph": state["deemph"].clone(),
          "rng": state["rng"].clone()}
    gap = torch.zeros((), device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    outs = torch.zeros((R, n), device=dev)
    pos = torch.zeros((1,), dtype=torch.int64, device=dev)

    def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return x.index_select(1, i)[:, 0]

    def step():
        frame = torch.div(pos, fs, rounding_mode="floor")
        ca, cb = at(conds["cond_a"], frame), at(conds["cond_b"], frame)
        lpc = at(conds["lpc"], frame)
        gru_a, gru_b, last_sig = st["gru_a"], st["gru_b"], st["last_sig"]
        exc, deemph = st["exc"], st["deemph"]
        pred = _lpc_pred(last_sig, lpc)
        zrh_a = (ca + tb["tbl_sig"][lin2ulaw(last_sig[:, 0]).long()]
                 + tb["tbl_pred"][lin2ulaw(pred).long()]
                 + tb["tbl_exc"][exc])
        gru_a = layers.gru_gates(gru_a, zrh_a,
                                 gru_a @ tb["wr_a"] + tb["br_a"])
        gru_b = layers.gru_gates(gru_b, cb + gru_a @ tb["wi_b"],
                                 gru_b @ tb["wr_b"] + tb["br_b"])
        logits = (torch.tanh(gru_b @ dfc["w"][0] + dfc["b"][0])
                  * dfc["factor"][0]
                  + torch.tanh(gru_b @ dfc["w"][1] + dfc["b"][1])
                  * dfc["factor"][1])
        thr, rng = _thresholds(st["rng"], logit_tbl)
        own = torch.zeros((R,), dtype=torch.int64, device=dev)
        for b in range(8):
            lg = logits.gather(1, (own | (1 << b))[:, None])[:, 0]
            own = (own << 1) | (thr[:, b] < lg).long()
        base = pred + pre * deemph
        if forced is not None:
            f_s, t_s = at(forced, pos), at(target, pos)
        if out is None:
            new = own
        else:
            o_s = out.index_select(1, pos)
            cand = torch.floor(0.5 + torch.clamp(
                base[:, None] + u2l[None, :], -32767.0, 32767.0))
            dist = (cand - o_s).abs()
            lim = 1.0 if tol is None else at(tol, pos)
            dmin = dist.min(-1).values
            d_own = dist.gather(1, own[:, None])[:, 0]
            new = torch.where((d_own <= dmin) | (d_own <= lim), own,
                              dist.argmin(-1))
            free = dmin <= lim
            if forced is not None:
                free = free | f_s
                off.add_((f_s & (o_s[:, 0] != t_s)).sum())
            off.add_((~free).sum())
            viol = torch.zeros((R,), device=dev)
            for b in range(8):
                node, bit = _node(new, b)
                lg = logits.gather(1, node[:, None])[:, 0]
                viol = torch.maximum(viol, torch.where(
                    bit == 1, thr[:, b] - lg, lg - thr[:, b]))
            if forced is not None:
                viol = torch.where(f_s, 0.0, viol)
            gap.copy_(torch.maximum(gap, viol.max()))
        pcm = pred + u2l[new]
        if forced is not None:
            tf_sig = t_s - pre * deemph
            new = torch.where(f_s, lin2ulaw(tf_sig - pred).long(), new)
            pcm = torch.where(f_s, tf_sig, pcm)
        last_sig = torch.cat([pcm[:, None], last_sig[:, :-1]], dim=-1)
        deemph = pcm + pre * deemph
        o = torch.floor(0.5 + torch.clamp(deemph, -32767.0, 32767.0))
        if forced is not None:
            o = torch.where(f_s, t_s, o)
        outs.index_copy_(1, pos, o[:, None])
        for k, v in (("gru_a", gru_a), ("gru_b", gru_b),
                     ("last_sig", last_sig), ("exc", new),
                     ("deemph", deemph), ("rng", rng)):
            st[k].copy_(v)
        pos.add_(1)

    warm = n if dev.type != "cuda" else min(n, WARM_STEPS)
    for _ in range(warm):
        step()
    if warm < n:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(n - warm):
            graph.replay()
    new_state = {"gru_a": st["gru_a"], "gru_b": st["gru_b"],
                 "last_sig": st["last_sig"],
                 "last_exc": st["exc"].to(torch.int32),
                 "deemph": st["deemph"], "rng": st["rng"]}
    return new_state, outs, {
        "tree_gap": float(gap.clamp(min=0.0)), "pcm_off": int(off)}
