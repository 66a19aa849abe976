"""DRED RDO-VAE, inference part (the port of lpcnet_tpu/models/rdovae.py;
reference training_tf2/rdovae.py:256-557, C inference
src/dred_rdovae_{enc,dec}.c).

Structure (per 20-ms "dframe" = 4 feature frames):
  encoder: feature pairs (40) -> [Dense tanh | GRU | Dense | GRU | Dense |
    GRU | Dense | Dense], all-layer concat -> causal Conv1D(k=4) -> 80
    latents; concat -> Dense128 -> Dense24 tanh initial decoder state
  quantization: per-lambda Embedding(16, 6*80) giving scale (softplus),
    dead zone (softplus), soft and hard entropy-model parameters (sigmoid);
    the decoder state is PVQ-quantized with k=82
  decoder: the mirrored stack over the time-reversed latents, 3
    state-init denses, `final` emits 4 feature frames per latent step

The products are float32 matmuls. On the card they refuse to run while
torch.backends.cuda.matmul.allow_tf32 is set: TF32 keeps ~3 decimal
digits and flips DRED symbols, as it flips the codec's VQ choices. The
causal conv is four shifted products, not torch's conv1d, whose cuDNN
path runs float32 in TF32 by default. The initializers, the training-time
quantizers and the losses belong to training and are not here.
"""
import dataclasses
from typing import Dict

import torch

from ..constants import (DRED_COND_SIZE, DRED_LATENT_DIM, DRED_NUM_FEATURES,
                         DRED_NUM_QUANT_LEVELS, DRED_PVQ_K, DRED_STATE_DIM)
from ..device import refuse_tf32
from . import layers


@dataclasses.dataclass(frozen=True)
class RDOVAEConfig:
    nb_features: int = DRED_NUM_FEATURES
    nb_latents: int = DRED_LATENT_DIM
    bunch: int = 4
    nb_quant: int = DRED_NUM_QUANT_LEVELS   # lambda quantization levels
    cond_size: int = DRED_COND_SIZE         # GRU width
    cond_size2: int = 256                   # dense width
    state_dim: int = DRED_STATE_DIM
    pvq_k: int = DRED_PVQ_K
    approx: bool = False

    @property
    def pair_size(self) -> int:
        return 2 * self.nb_features  # the encoder takes feature pairs

    @property
    def concat_size(self) -> int:
        return 3 * self.cond_size2 + 5 * self.cond_size


def _stack(p, x, h0s, ap):
    """The 8-layer stack shared by encoder and decoder: dense, GRU, dense,
    GRU, dense, GRU, dense, dense, each layer's output kept; h0s are the
    three GRUs' initial states. Returns the concat (B, T, concat_size)."""
    outs = [layers.dense_apply(p["dense1"], x, "tanh", ap)]
    for gru, dense, h0 in (("gru2", "dense3", h0s[0]),
                           ("gru4", "dense5", h0s[1]),
                           ("gru6", "dense7", h0s[2])):
        outs.append(layers.gru_sequence(p[gru], outs[-1], h0, approx=ap))
        outs.append(layers.dense_apply(p[dense], outs[-1], "tanh", ap))
    outs.append(layers.dense_apply(p["dense8"], outs[-1], "tanh", ap))
    return torch.cat(outs, dim=-1)


def encode(params, feats: torch.Tensor, cfg: RDOVAEConfig = RDOVAEConfig()):
    """feats: (B, T, 20) with T even -> (z (B, T/2, 80), state (B, T/2,
    24)), one latent per feature pair (rdovae.py:257-329); the dframe rate
    is every second one (DREDCodec)."""
    refuse_tf32(feats, "the RDO-VAE encoder's products (TF32 flips DRED "
                "symbols)")
    p = params["enc"]
    ap = cfg.approx
    B, T, F = feats.shape
    x = feats.reshape(B, T // 2, 2 * F)
    h0 = feats.new_zeros((B, cfg.cond_size))
    pre = _stack(p, x, (h0, h0, h0), ap)
    # causal conv k=4 (Keras padding='causal'): output t takes the inputs
    # t-3..t; each tap's product shifted in time, the taps added in order
    w = p["bits_conv"]["w"]
    k = w.shape[0]
    z = None
    for j in range(k):
        y = pre @ w[j]
        y = torch.nn.functional.pad(y, (0, 0, k - 1 - j, 0))[:, :T // 2]
        z = y if z is None else z + y
    z = z + p["bits_conv"]["b"]
    g = layers.dense_apply(p["gdense1"], pre, "tanh", ap)
    state = layers.dense_apply(p["gdense2"], g, "tanh", ap)
    return z, state


def decode(params, z: torch.Tensor, init_state: torch.Tensor,
           cfg: RDOVAEConfig = RDOVAEConfig()):
    """z: (B, S, 80) latents, one per dframe, oldest first; init_state:
    (B, 24). Returns (B, S*4, 20) feature frames, oldest first. The
    latents are decoded time-reversed (rdovae.py:395-414)."""
    refuse_tf32(z, "the RDO-VAE decoder's products")
    p = params["dec"]
    ap = cfg.approx
    B = z.shape[0]
    h0s = [layers.dense_apply(p[k], init_state, "tanh", ap)
           for k in ("state1", "state2", "state3")]
    cat = _stack(p, torch.flip(z, [1]), h0s, ap)
    quad = layers.dense_apply(p["final"], cat, "linear", ap)
    return torch.flip(quad.reshape(B, -1, cfg.nb_features), [1])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) in jax.nn.softplus's form, logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def quant_params(params, quant_id: torch.Tensor,
                 cfg: RDOVAEConfig) -> Dict[str, torch.Tensor]:
    """Per-position quantizer parameters from the lambda embedding
    (rdovae.py:465-512). quant_id: (...,) integer in [0, nb_quant).
    Returns dict(scale, dead_zone, soft, hard)."""
    nb = cfg.nb_latents
    e = params["quant_embed"]["e"][torch.as_tensor(quant_id).long()]
    return {"scale": _softplus(e[..., :nb]),
            "dead_zone": _softplus(e[..., nb:2 * nb]),
            "soft": torch.sigmoid(e[..., 2 * nb:4 * nb]),
            "hard": torch.sigmoid(e[..., 4 * nb:6 * nb])}


def apply_dead_zone(x: torch.Tensor, dead_zone: torch.Tensor) -> torch.Tensor:
    """y = x - d*tanh(x / (.1 + d)), d = .05*dead_zone (rdovae.py:103-107)."""
    d = dead_zone * 0.05
    return x - d * torch.tanh(x / (0.1 + d))


def pvq_quantize(x: torch.Tensor, k: int, iters: int = 10) -> torch.Tensor:
    """Unit-norm PVQ with k pulses (rdovae.py:210-247), the forward value
    of the JAX package's straight-through form: xn + (q - xn), rounded as
    it rounds. x: (..., D)."""
    xn = x / (1e-15 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))
    xl1 = xn / torch.sum(torch.abs(xn), dim=-1, keepdim=True)
    kx = k * xl1
    y = torch.round(kx)
    newk = torch.full(x.shape[:-1] + (1,), float(k), dtype=x.dtype,
                      device=x.device)
    for _ in range(iters):
        kk = torch.sum(torch.abs(y), dim=-1, keepdim=True)
        plus = 1.000001 * torch.amin(
            (torch.abs(y) + 0.5) / (torch.abs(kx) + 1e-15), dim=-1,
            keepdim=True)
        minus = 0.999999 * torch.amax(
            (torch.abs(y) - 0.5) / (torch.abs(kx) + 1e-15), dim=-1,
            keepdim=True)
        factor = torch.where(kk > k, minus, plus)
        factor = torch.where(kk == k, torch.ones_like(factor), factor)
        newk = newk * factor
        kx = newk * xl1
        y = torch.round(kx)
    q = y / (1e-15 + torch.linalg.vector_norm(y, dim=-1, keepdim=True))
    return xn + (q - xn)
