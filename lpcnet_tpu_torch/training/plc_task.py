"""PLC training task (the port of lpcnet_tpu/training/plc_task.py;
reference training_tf2/train_plc.py and plc_loader.py).

Loss: masked feature L1 + idct band L1 (+ optional signed bias) + clamped
pitch terms + correlation hinge (plc_loss, train_plc.py:160-178). Loss
simulation: real loss traces with random offsets and independent 10%
Burg dropout (plc_loader.py:56-89), the dropout drawn from a generator or
passed in.
"""
from typing import Union

import torch

from ..constants import NB_BANDS
from ..device import refuse_tf32
from ..models import plc as plc_model
from ..ops import dsp, ties
from ..utils import graphs
from .optim import ScheduledAdam, value_and_grad


def plc_loss(y_true, y_pred, lost_mask, alpha: float = 1.0,
             bias: float = 0.0):
    """train_plc.py:160-178. y_true, y_pred: (B, T, 20); lost_mask:
    (B, T, 1), 1 on LOST frames: the loss supervises the frames the net
    must conceal."""
    e = (y_pred - y_true) * lost_mask
    e_bands = dsp.idct(e[..., :NB_BANDS])
    bias_mask = ties.clip(4.0 * y_true[..., 19:20], 0.0, 1.0)
    e18 = ties.abs(e[..., 18:19])
    return (torch.mean(ties.abs(e))
            + 0.1 * torch.mean(ties.maximum(-e[..., 19:20], 0.0))
            + alpha * torch.mean(ties.abs(e_bands) + bias * bias_mask
                                 * ties.maximum(e_bands, 0.0))
            + torch.mean(ties.minimum(e18, 1.0))
            + 8.0 * torch.mean(ties.minimum(e18, 0.4)))


def make_batch(burg_draw: Union[torch.Generator, torch.Tensor],
               features: torch.Tensor, lost_trace: torch.Tensor):
    """PLC training inputs from clean [burg36 | feat20] sequences and a
    loss trace (plc_loader.py:56-89). features: (B, T, 56); lost_trace:
    (B, T), 1 = received; burg_draw: a generator on features' device, or
    the (B, T, 1) U(0, 1) draws themselves (a frame keeps its Burg
    cepstra where its draw exceeds 0.1).
    Returns dict(inputs (B, T, 57), targets (B, T, 20), mask (B, T, 1))."""
    B, T, _ = features.shape
    nb_burg = 2 * NB_BANDS
    received = lost_trace[..., None].to(torch.float32)
    if isinstance(burg_draw, torch.Generator):
        burg_draw = torch.rand((B, T, 1), generator=burg_draw,
                               device=features.device)
    burg_ok = (burg_draw > 0.1).to(torch.float32)
    in_feats = features * received
    in_feats = torch.cat([in_feats[..., :nb_burg] * burg_ok,
                          in_feats[..., nb_burg:]], dim=-1)
    flag = received * (2.0 * burg_ok - 1.0)          # {1, -1}, 0 lost
    return {"inputs": torch.cat([in_feats, flag], dim=-1),
            "targets": features[..., nb_burg:], "mask": 1.0 - received}


def loss_fn(params, batch, cfg=plc_model.PLCConfig(), alpha=1.0, bias=0.0):
    refuse_tf32(batch["inputs"], "the PLC training products")
    pred = plc_model.forward_sequence(params, batch["inputs"], cfg)
    total = plc_loss(batch["targets"], pred, batch["mask"], alpha, bias)
    e = (pred - batch["targets"]) * batch["mask"]
    return total, {"loss": total, "l1": torch.mean(torch.abs(e)),
                   "ceps_l1": torch.mean(torch.abs(e[..., :NB_BANDS]))}


def make_optimizer(lr: float = 1e-3, decay: float = 2.5e-5) -> ScheduledAdam:
    """Adam(b2=.99) with lr / (1 + decay t) (train_plc.py:143-148, :225)."""
    return ScheduledAdam(lr=lr, decay=decay, b2=0.99)


def _train_step(params, opt_state, batch, cfg, opt: ScheduledAdam):
    (_, metrics), grads = value_and_grad(
        lambda p: loss_fn(p, batch, cfg), params)
    params, opt_state = opt.apply(params, grads, opt_state)
    return params, opt_state, metrics


# train_step(params, opt_state, batch, cfg, opt), jax.jit's counterpart
# with cfg and opt static (lpcnet_task.train_step says how); make_batch
# draws the Burg dropout outside the step
train_step = graphs.jit(_train_step, "plc_task.train_step")
