"""RDO-VAE training task (the port of lpcnet_tpu/training/rdovae_task.py;
reference training_tf2/train_rdovae.py and the end-to-end graph
rdovae.py:447-557).

Per batch: a quantization level per sequence, latents encoded at 50 Hz,
scaled and dead-zoned, two quantization paths (hard rounding with a
straight-through gradient, additive uniform noise), both dframe offsets
decoded through the split decoder from PVQ-quantized resume states, and
the loss [feat_dist(hard), feat_dist(noise), sq1_rate, sq2_rate] with
weights [.5, .5, 1, .1] (train_rdovae.py:149-159). The level and the
noise come from a generator or are passed in.
"""
from typing import Union

import torch

from ..models import rdovae as rv
from ..utils import graphs
from .lpcnet_task import clip_kernel
from .optim import ScheduledAdam, value_and_grad


def sample_lambda(draw: Union[torch.Generator, torch.Tensor], batch: int,
                  nsteps: int, nb_quant: int = 16, device=None):
    """Per-sequence quant level and lambda (train_rdovae.py:183-189). draw:
    a generator on `device`, or the (batch, 1) integer levels themselves.
    Returns (quant_id (B, nsteps) int64, lam (B, nsteps, 1))."""
    if isinstance(draw, torch.Generator):
        draw = torch.randint(0, nb_quant, (batch, 1), generator=draw,
                             device=device)
    q = draw.expand(batch, nsteps)
    lam = 2e-4 * torch.exp(q.to(torch.float32) / 3.8)
    return q, lam[..., None]


def split_decode(params, z, states, cfg: rv.RDOVAEConfig,
                 nb_chunks: int = 4):
    """Chunked decode with quantized resume states (rdovae.py:413-431). z:
    (B, S, 80) dframe-rate latents; states: (B, S, 24) PVQ states. Chunk
    [b, e) decodes from the state at its last step."""
    S = z.shape[1]
    L = max(1, -(-S // nb_chunks))
    outs = []
    for c in range(nb_chunks):
        b, e = c * L, min((c + 1) * L, S)
        if b >= e:
            break
        outs.append(rv.decode(params, z[:, b:e], states[:, e - 1], cfg))
    return torch.cat(outs, dim=1)


def _tensor_concat(outs):
    """Align the two offset decodes (rdovae.py:433-444): 2 x (B, T, 20) ->
    (2, B, T, 20)."""
    x0, x1 = outs
    row0 = torch.cat([x0[:, 2:], x1[:, -2:]], dim=1)
    return torch.stack([row0, x1], dim=0)


def forward(params, feats, quant_id,
            noise: Union[torch.Generator, torch.Tensor],
            cfg: rv.RDOVAEConfig):
    """feats: (B, T, 20) (T % 8 == 0), quant_id: (B, T/2); noise: a
    generator on feats' device, or the (B, T/2, 80) U(-.5, .5) noise
    draws themselves. Returns the decoded outputs and the rate losses'
    ingredients."""
    z, state = rv.encode(params, feats, cfg)          # (B, T/2, .)
    qp = rv.quant_params(params, quant_id, cfg)
    dze = rv.apply_dead_zone(z * qp["scale"], qp["dead_zone"])
    # noise quantization (uniform_noise.py:53-66)
    ndze = (rv.noise_quantize(noise, dze) if isinstance(noise, torch.Generator)
            else dze + noise)
    dze_quant = rv.hard_quantize(dze) / qp["scale"]
    ndze_unquant = ndze / qp["scale"]
    state_q = rv.pvq_quantize(state, cfg.pvq_k)
    hard_outs, noise_outs = [], []
    for i in range(cfg.bunch // 2):
        si = state_q[:, i::2]
        hard_outs.append(split_decode(params, dze_quant[:, i::2], si, cfg))
        noise_outs.append(split_decode(params, ndze_unquant[:, i::2], si,
                                       cfg))
    return {"combined": _tensor_concat(hard_outs),
            "unquant": _tensor_concat(noise_outs), "dze": dze,
            "soft": qp["soft"], "hard": qp["hard"]}


def loss_fn(params, feats, quant_id, lam, noise, cfg: rv.RDOVAEConfig,
            weights=(0.5, 0.5, 1.0, 0.1)):
    out = forward(params, feats, quant_id, noise, cfg)
    lam_up = lam.repeat_interleave(2, dim=1)    # pair rate -> frame rate
    fd_hard = rv.feat_dist_loss(feats[None], out["combined"], lam_up[None])
    fd_noise = rv.feat_dist_loss(feats[None], out["unquant"], lam_up[None])
    r1 = rv.sq1_rate_loss(out["dze"], out["soft"], lam)
    r2 = rv.sq2_rate_loss(out["dze"], out["hard"], lam)
    total = (weights[0] * fd_hard + weights[1] * fd_noise
             + weights[2] * r1 + weights[3] * r2)
    return total, {"loss": total, "feat_dist_hard": fd_hard,
                   "feat_dist_noise": fd_noise, "rate_soft": r1,
                   "rate_hard": r2,
                   "bits_per_dframe": rv.sq_rate_metric(out["dze"],
                                                        out["hard"])}


def weight_clip(params, c: float = 0.496):
    """WeightClip(0.496) on every 2-D dense and GRU kernel (rdovae.py:
    60-83)."""
    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict) and ("w" in v or "wi" in v):
                out[k] = {kk: clip_kernel(vv, c)
                          if kk in ("w", "wi", "wr") and vv.ndim == 2 else vv
                          for kk, vv in v.items()}
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(params)


def make_optimizer(lr: float = 1e-3, decay: float = 2.5e-5) -> ScheduledAdam:
    """Adam(b2=.99) with lr / (1 + decay t) (train_rdovae.py:139)."""
    return ScheduledAdam(lr=lr, decay=decay, b2=0.99)


def _train_step(params, opt_state, feats, quant_id, lam, noise, cfg,
                opt: ScheduledAdam):
    (_, metrics), grads = value_and_grad(
        lambda p: loss_fn(p, feats, quant_id, lam, noise, cfg), params)
    params, opt_state = opt.apply(params, grads, opt_state)
    with torch.no_grad():
        params = weight_clip(params)
    return params, opt_state, metrics


# train_step(params, opt_state, feats, quant_id, lam, noise, cfg, opt),
# jax.jit's counterpart with cfg and opt static (lpcnet_task.train_step
# says how); a noise generator is registered with the graph, so a replay
# draws what an eager step would at that point, also after sample_lambda
# has drawn from the same generator between steps
train_step = graphs.jit(_train_step, "rdovae_task.train_step")
