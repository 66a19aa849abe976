"""LPCNet training task: the teacher-forced forward pass, the loss, the
weight constraint and the train step (the port of
lpcnet_tpu/training/lpcnet_task.py; reference training_tf2/lpcnet.py:
312-475).

As in the JAX package, everything parallel in time is lifted out of the
recurrence: the input-side GRU products run as one (B*S, in) x (in, 3N)
matmul, and only the recurrent part runs step by step (layers.gru_scan).
Gradients come from autograd; the products are float32 matmuls, which
refuse to run on the card while TF32 is allowed (device.refuse_tf32).

Data contract per batch (training_tf2/dataloader.py:17-70, src/
dump_data.c:84-108), tensors on one device:
  sig_in   (B, S)        lagged, noisy input signal (int16 range)
  sig_out  (B, S)        clean target signal
  features (B, T+4, 20)  feature frames with the convs' context
  periods  (B, T+4) int  pitch embedding indices
  lpc      (B, T, 16)    LPC per output frame
with S == T * frame_size.
"""
import functools
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import refuse_tf32
from ..models import layers
from ..models.lpcnet import LPCNetConfig
from ..ops import activations, ties
from ..ops.tables import device_constant
from ..utils import graphs
from . import losses
from .optim import ScheduledAdam, value_and_grad

# noise: None (no noise), a torch.Generator on the batch's device to draw
# from, or a dict of the standard-normal draws themselves: "cpcm"
# (B, S, 3) and "gru_a" (B, S, gru_a_units)
Noise = Union[None, torch.Generator, Dict[str, torch.Tensor]]


def _valid_frame_net(params, features, periods, cfg: LPCNetConfig):
    """Frame conditioning with valid padding: (B, T+4, .) -> (B, T, cond).
    The convs are shifted matmuls (cuDNN would run them in TF32)."""
    ap = cfg.approx
    pe = layers.embedding_apply(params["embed_pitch"], periods)
    x = torch.cat([features[..., :cfg.nb_features], pe], dim=-1)
    for name in ("conv1", "conv2"):
        w = params[name]["w"]
        k = w.shape[0]
        n = x.shape[1] - k + 1
        y = x[:, 0:n] @ w[0]
        for j in range(1, k):
            y = y + x[:, j:j + n] @ w[j]
        x = activations.get("tanh", ap)(y + params[name]["b"])
    x = layers.dense_apply(params["dense1"], x, "tanh", ap)
    return layers.dense_apply(params["dense2"], x, "tanh", ap)


def _diff_embed(table, u):
    """Fractional embedding lookup (diffembed.py:42-49). u: continuous
    mu-law in [0, 255]; linear interpolation between adjacent rows."""
    alpha = (u - torch.floor(u))[..., None]
    lo = u.long()
    hi = torch.clamp(lo + 1, 0, 255)
    return (1 - alpha) * table[lo] + alpha * table[hi]


@functools.lru_cache(maxsize=None)
def _gamma_weights(gamma: float, order: int) -> np.ndarray:
    """gamma^i, i = 1..order, in float32: the bandwidth expansion of the
    LPC the network's input prediction uses (cached, so that
    device_constant keeps one tensor per device)."""
    return gamma ** np.arange(1, order + 1, dtype=np.float32)


def _draw(noise: Noise, key: str, shape, like: torch.Tensor):
    if isinstance(noise, torch.Generator):
        return torch.randn(shape, generator=noise, dtype=torch.float32,
                           device=like.device)
    return noise[key]


def forward(params, batch, cfg: LPCNetConfig, noise: Noise = None,
            train: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """Teacher-forced forward (training_tf2/lpcnet.py:357-439). Returns
    tensor_preds, real_preds, pdf and rc (None unless cfg.e2e). With
    train and noise, cpcm gets 0.3 N(0, 1) (lpcnet.py:371) and GRU-A's
    output 0.005 N(0, 1) (:425)."""
    fs = cfg.frame_size
    sig_in = batch["sig_in"].to(torch.float32)
    refuse_tf32(sig_in, "the LPCNet training products")
    B, S = sig_in.shape
    cfeat = _valid_frame_net(params, batch["features"], batch["periods"],
                             cfg)
    T = cfeat.shape[1]
    if T * fs != S:
        raise ValueError(f"{T} frames of {fs} samples for {S} samples")
    if cfg.e2e:
        rc = cfeat[..., :cfg.lpc_order]
        lpc = losses.rc2lpc(rc)
    else:
        rc = None
        lpc = batch["lpc"].to(torch.float32)

    gamma_w = device_constant(_gamma_weights(cfg.lpc_gamma, cfg.lpc_order),
                              sig_in.device)
    tensor_preds = losses.diff_pred(sig_in, lpc * gamma_w, fs)
    real_preds = losses.diff_pred(sig_in, lpc, fs)
    past_errors = losses.l2u(sig_in - torch.roll(tensor_preds, 1, dims=1))
    cpcm = torch.stack([losses.l2u(sig_in), losses.l2u(tensor_preds),
                        past_errors], dim=-1)                  # (B, S, 3)
    noisy = train and noise is not None
    if noisy:
        cpcm = cpcm + 0.3 * _draw(noise, "cpcm", cpcm.shape, cpcm)
    emb = _diff_embed(params["embed_sig"]["e"], ties.clip(cpcm, 0.0, 255.0))
    emb = emb.reshape(B, S, 3 * cfg.embed_sig_size)
    cfeat_rep = cfeat.repeat_interleave(fs, dim=1)             # (B, S, cond)

    ga, gb = params["gru_a"], params["gru_b"]
    zrh_a = torch.cat([emb, cfeat_rep], dim=-1) @ ga["wi"] + ga["bi"]
    out_a = layers.gru_scan(zrh_a, sig_in.new_zeros((B, cfg.gru_a_units)),
                            ga["wr"], ga["br"], approx=cfg.approx)
    if noisy:
        out_a = out_a + 0.005 * _draw(noise, "gru_a", out_a.shape, out_a)
    zrh_b = torch.cat([out_a, cfeat_rep], dim=-1) @ gb["wi"] + gb["bi"]
    out_b = layers.gru_scan(zrh_b, sig_in.new_zeros((B, cfg.gru_b_units)),
                            gb["wr"], gb["br"], approx=cfg.approx)

    # dual FC with sigmoid (tree-node probabilities), then tree -> pdf
    nodes = activations.get("sigmoid", cfg.approx)(
        layers.dualfc_logits(params["dual_fc"], out_b, cfg.approx))
    return {"tensor_preds": tensor_preds, "real_preds": real_preds,
            "pdf": losses.tree_to_pdf(nodes), "rc": rc}


def loss_fn(params, batch, cfg: LPCNetConfig, noise: Noise = None,
            train: bool = True):
    """(total loss, metrics dict of 0-d tensors). Non-e2e: the rounded CE;
    e2e: interp_mulaw (gamma 2) + 2 * matchlar (train_lpcnet.py:244-254)."""
    out = forward(params, batch, cfg, noise, train)
    sig_out = batch["sig_out"].to(torch.float32)
    cel = torch.mean(losses.metric_cel(sig_out, out["tensor_preds"],
                                       out["pdf"]))
    if cfg.e2e:
        lm = losses.interp_mulaw(sig_out, out["tensor_preds"],
                                 out["real_preds"], out["pdf"], gamma=2.0)
        rc_true = losses.lpc2rc(batch["lpc"].to(torch.float32))
        ml = losses.loss_matchlar(rc_true, out["rc"])
        total = torch.mean(lm) + 2.0 * torch.mean(ml)
    else:
        total = cel
    return total, {"loss": total, "cel": cel}


def clip_kernel(p: torch.Tensor, c: float) -> torch.Tensor:
    """Rescale a kernel (in, out) so |w[2i]| + |w[2i+1]| <= c along the
    input axis (WeightClip, lpcnet.py:287-309)."""
    a = torch.abs(p)
    pair = a[0::2] + a[1::2]
    return c * p / torch.maximum(p.new_full((), c),
                                 pair.repeat_interleave(2, dim=0))


def weight_clip(params, c: float = 0.992):
    """WeightClip(0.992) on GRU-A's recurrent and GRU-B's kernels (avoids
    int8 dot-product saturation)."""
    out = dict(params)
    out["gru_a"] = dict(params["gru_a"], wr=clip_kernel(
        params["gru_a"]["wr"], c))
    out["gru_b"] = dict(params["gru_b"],
                        wi=clip_kernel(params["gru_b"]["wi"], c),
                        wr=clip_kernel(params["gru_b"]["wr"], c))
    return out


def make_optimizer(lr: float = 1e-3, decay: float = 5e-5, b1: float = 0.5,
                   b2: float = 0.8) -> ScheduledAdam:
    """Adam(.5, .8) with lr / (1 + decay t), the reference's optimizer
    (train_lpcnet.py:229)."""
    return ScheduledAdam(lr=lr, decay=decay, b1=b1, b2=b2)


def _train_step(params, opt_state, batch, cfg: LPCNetConfig,
                opt: ScheduledAdam, noise: Noise = None):
    """One step: loss and gradients, the Adam update, the weight clip.
    Returns (params, opt_state, metrics)."""
    (_, metrics), grads = value_and_grad(
        lambda p: loss_fn(p, batch, cfg, noise), params)
    params, opt_state = opt.apply(params, grads, opt_state)
    with torch.no_grad():
        params = weight_clip(params)
    return params, opt_state, metrics


# train_step(params, opt_state, batch, cfg, opt, noise=None), the
# counterpart of jax.jit(train_step, static_argnames=("cfg", "opt")): cfg
# and opt are hashable leaves of the signature, a noise generator is held
# by identity and registered with the graph (utils/graphs.py). On the card
# the first step of a signature runs eagerly, the second is captured, and
# it and every later step replay the graph; on the CPU and inside
# graphs.disabled() every step runs eagerly.
train_step = graphs.jit(_train_step, "lpcnet_task.train_step")
