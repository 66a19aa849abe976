"""One step of the causal packet-loss concealment in plain PyTorch: the
reference's lpcnet_plc_update / lpcnet_plc_conceal (src/lpcnet_plc.c) in
the batched, masked form whose state the program keeps, with DC removal
off and no FEC frames queued.

Per 10-ms frame and stream: Burg's cepstral analysis of the incoming
frame; the feature extractor advanced on the previous frame's output and
run on this frame's input; one PLC-network step for the lost or
first-good ("blend") input and one for the good input; the concealment
features (the prediction, c0 attenuated by the losses so far); the frame
network's conditioning; then 160 samples of the sample loop: lost streams
free-run, good streams follow their input, blend streams free-run the
first half (cross-faded with the input) and follow the input after it.

step(..., out=program's output) runs that loop along the program's
samples (sample_check.follow) and returns its tree_gap and pcm_off;
out=None samples on its own, the reference in the program's place.
"""
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import sample_check
from .frozen import features as F
from .frozen.constants import (FRAME_SIZE, NB_BANDS, NB_FEATURES,
                               NB_TOTAL_FEATURES, PLC_MAX_FEC,
                               TRAINING_OFFSET)
from .frozen.models import lpcnet as lpcnet_model
from .frozen.models import plc as plc_model
from .frozen.ops import burg

# c0 attenuation after n losses (lpcnet_plc.c:292)
ATT = [0, 0, -.2, -.2, -.4, -.4, -.8, -.8, -1.6, -1.6]


def init_state(n: int, cfg, plc_cfg, device) -> Dict[str, Any]:
    """n fresh streams (lpcnet_plc_init; every stream's RNG seeded as the
    reference seeds it)."""
    net = plc_model.init_net_state(n, plc_cfg, device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    i32 = torch.int32
    return {"synth": sample_check.init_state(n, cfg, device,
                                             per_stream=False),
            "fnet": lpcnet_model.frame_net_init_state(n, cfg, device),
            "enc": F.init_state(n, device),
            "plc_net": net,
            "plc_copies": {k: v[:, None].repeat(1, cfg.lookahead + 1, 1)
                           for k, v in net.items()},
            "loss_count": z(n, dtype=i32), "blend": z(n, dtype=torch.bool),
            "fec": z(n, PLC_MAX_FEC, NB_FEATURES),
            "fec_fill": z(n, dtype=i32), "fec_read": z(n, dtype=i32),
            "fec_keep": z(n, dtype=i32), "fec_skip": z(n, dtype=i32),
            "dc_mem": z(n), "syn_dc": z(n), "prev_out": z(n, FRAME_SIZE)}


def _attenuation(loss_count: torch.Tensor) -> torch.Tensor:
    lc = loss_count.to(torch.float32)
    table = torch.as_tensor(np.asarray(ATT, np.float32),
                            device=loss_count.device)
    return torch.where(loss_count >= 10, ATT[9] - 2.0 * (lc - 9.0),
                       table[torch.clamp(loss_count, 0, 9).long()])


def _pad36(f20: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(f20, (0, NB_TOTAL_FEATURES - NB_FEATURES))


def _where(mask, a, b):
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


@torch.no_grad()
def step(params, plc_params, tb, cfg, plc_cfg, state, pcm, lost,
         out: Optional[torch.Tensor] = None):
    """One frame for R streams: pcm (R, 160), lost (R,) bool; `out` the
    program's output of the frame (or None). Returns (new state, output
    (R, 160), {"tree_gap", "pcm_off"})."""
    R, dev = pcm.shape[0], pcm.device
    burg36 = burg.burg_cepstral_analysis(pcm)
    _, featsg, _, enc_mid = F.compute_features(
        state["enc"], torch.cat([state["prev_out"], pcm], dim=-1),
        mode="single", return_mid=True)
    featg = featsg[:, 1, :NB_FEATURES]
    has_fec = ((state["fec_read"] < state["fec_fill"])
               & (state["fec_skip"] == 0) & lost)
    rd = torch.clamp(state["fec_read"], 0, PLC_MAX_FEC - 1).long()
    fec_feat = state["fec"][torch.arange(R, device=dev), rd]
    zeros36 = torch.zeros((R, 2 * NB_BANDS), device=dev)
    zeros20 = torch.zeros((R, NB_FEATURES), device=dev)
    one = torch.ones((R, 1), device=dev)
    blend = state["blend"] & ~lost
    in_blend = torch.cat([burg36, zeros20, one], dim=-1)
    in_lost = torch.cat([zeros36, zeros20, 0 * one], dim=-1)
    in_fec = torch.cat([zeros36, fec_feat, -one], dim=-1)
    x_lb = _where(lost, _where(has_fec, in_fec, in_lost), in_blend)
    in_good = torch.cat([burg36, featg, one], dim=-1)
    copies = state["plc_copies"]
    net_in = {k: _where(blend, copies[k][:, -1], v)
              for k, v in state["plc_net"].items()}
    new_copies = {k: _where(lost, torch.cat([net_in[k][:, None],
                                             cp[:, :-1]], dim=1), cp)
                  for k, cp in copies.items()}
    net_lb, pred = plc_model.step(plc_params, net_in, x_lb, plc_cfg)
    net_g, _ = plc_model.step(plc_params, state["plc_net"], in_good,
                              plc_cfg)
    lc = state["loss_count"]
    p = _where(has_fec, fec_feat, pred)
    c0 = torch.clamp(p[:, :1] + _attenuation(lc)[:, None], min=-10.0)
    feat_lost = _pad36(torch.cat([c0, p[:, 1:]], dim=-1))
    feats = _where(lost, feat_lost, _pad36(_where(blend, pred, featg)))
    new_fnet, cond = lpcnet_model.frame_net_step(params, tb, state["fnet"],
                                                 feats, cfg)
    cond = {k: cond[k][:, None] for k in ("cond_a", "cond_b", "lpc")}
    fs = cfg.frame_size
    i = torch.arange(fs, device=dev)
    force_from = torch.where(lost, fs, torch.where(blend, TRAINING_OFFSET,
                                                   0))
    forced = i[None, :] >= force_from[:, None]
    w = 0.5 - 0.5 * torch.cos(math.pi * torch.arange(
        TRAINING_OFFSET, dtype=torch.float32, device=dev) / TRAINING_OFFSET)
    tol = None
    if out is not None:
        # blend streams' output mixes the samples with the input over the
        # first half frame: take the samples back out of the mix, and let
        # the tolerance grow as the samples' weight falls
        head = (out[:, :TRAINING_OFFSET] - w * pcm[:, :TRAINING_OFFSET]) \
            / (1.0 - w)
        synth = torch.where(blend[:, None], torch.cat(
            [head, out[:, TRAINING_OFFSET:]], dim=-1), out)
        tol = torch.where(blend[:, None], torch.cat(
            [1.0 / (1.0 - w) + 0.5,
             torch.ones(fs - TRAINING_OFFSET, device=dev)]),
            torch.ones(fs, device=dev))
    else:
        synth = None
    new_synth, synth_out, stats = sample_check.follow(
        tb, cfg, state["synth"], cond, synth, target=pcm, forced=forced,
        tol=tol)
    warm = new_fnet["frame_count"] > cfg.lookahead
    synth_out = torch.where(warm[:, None], synth_out, 0.0)
    fade = w * pcm[:, :TRAINING_OFFSET] \
        + (1 - w) * synth_out[:, :TRAINING_OFFSET]
    blended = torch.cat([fade, pcm[:, TRAINING_OFFSET:]], dim=-1)
    output = _where(lost, synth_out, _where(blend, blended, pcm))
    fec_read, fec_skip = state["fec_read"], state["fec_skip"]
    good = ~lost & ~blend
    consume = has_fec | (good & (fec_read < state["fec_fill"])
                         & (fec_skip == 0))
    fec_read = torch.where(consume, fec_read + 1, fec_read)
    fec_skip = torch.where(good & (fec_skip > 0), fec_skip - 1, fec_skip)
    fec_keep = torch.maximum(state["fec_keep"],
                             torch.clamp(fec_read - cfg.lookahead - 1, min=0))
    fec_read = torch.where(blend, torch.maximum(fec_keep,
                                                fec_read - cfg.lookahead),
                           fec_read)
    lost_or_blend = lost | blend
    new = dict(state)
    new.update({
        "synth": new_synth, "fnet": new_fnet, "enc": enc_mid,
        "prev_out": output,
        "plc_net": {k: _where(lost_or_blend, net_lb[k], net_g[k])
                    for k in net_lb},
        "plc_copies": new_copies,
        "loss_count": torch.where(lost, torch.where(has_fec, 0, lc + 1),
                                  0).to(torch.int32),
        "blend": lost, "fec_read": fec_read, "fec_skip": fec_skip,
        "fec_keep": fec_keep})
    return new, output, stats
