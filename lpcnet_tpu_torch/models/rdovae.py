"""DRED RDO-VAE (the port of lpcnet_tpu/models/rdovae.py;
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
path runs float32 in TF32 by default. encode and a streaming sender
share encode_stack; the sender runs it a dframe at a time from kept GRU
states (and their first recurrent products, recurrent_products), and
encode_heads from the conv's carry (conv_taps regroups its taps so that
one product gives a dframe's latent and its share of the next one's).
The initializers, the training-time quantizer hard_quantize and the
rate-distortion losses serve training/rdovae_task.py; their gradients
follow JAX's at ties (ops/ties.py).
"""
import dataclasses
from typing import Dict

import numpy as np
import torch

from ..constants import (DRED_COND_SIZE, DRED_LATENT_DIM, DRED_NUM_FEATURES,
                         DRED_NUM_QUANT_LEVELS, DRED_PVQ_K, DRED_STATE_DIM)
from ..device import refuse_tf32
from ..ops import ties
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


def init_params(gen: torch.Generator, cfg: RDOVAEConfig = RDOVAEConfig()):
    """A fresh parameter tree (lpcnet_tpu/models/rdovae.py::init_params):
    float32 tensors on the CPU drawn from gen; the quant embedding starts
    at zero (rdovae.py:466)."""
    c, c2 = cfg.cond_size, cfg.cond_size2

    def stack(nin):
        return {"dense1": layers.dense_init(gen, nin, c2),
                "gru2": layers.gru_init(gen, c2, c),
                "dense3": layers.dense_init(gen, c, c2),
                "gru4": layers.gru_init(gen, c2, c),
                "dense5": layers.dense_init(gen, c, c2),
                "gru6": layers.gru_init(gen, c2, c),
                "dense7": layers.dense_init(gen, c, c),
                "dense8": layers.dense_init(gen, c, c)}

    enc = stack(cfg.pair_size)
    enc.update(bits_conv=layers.conv1d_init(gen, cfg.concat_size,
                                            cfg.nb_latents, 4),
               gdense1=layers.dense_init(gen, cfg.concat_size, 128),
               gdense2=layers.dense_init(gen, 128, cfg.state_dim))
    dec = stack(cfg.nb_latents)
    dec.update({k: layers.dense_init(gen, cfg.state_dim, c)
                for k in ("state1", "state2", "state3")})
    dec["final"] = layers.dense_init(gen, cfg.concat_size,
                                     cfg.bunch * cfg.nb_features)
    quant = {"e": torch.zeros((cfg.nb_quant, 6 * cfg.nb_latents),
                              dtype=torch.float32)}
    return {"enc": enc, "dec": dec, "quant_embed": quant}


def rate_aware_quant_init(params, cfg: RDOVAEConfig = RDOVAEConfig(),
                          lam_min: float = 2e-4, denom: float = 3.8):
    """The per-level quantizer scales on the uniform quantizer's
    rate-distortion optimum, scale(q) = softplus(0) * sqrt(lam(q) /
    lam(mid)), in place of the all-equal zero init
    (lpcnet_tpu/models/rdovae.py::rate_aware_quant_init): the scale
    columns of the quant embedding take softplus^-1 of that, computed in
    numpy as the JAX package does."""
    nb, nq = cfg.nb_latents, cfg.nb_quant
    q = np.arange(nq, dtype=np.float32)
    lam = lam_min * np.exp(q / denom)
    mid = lam_min * np.exp(0.5 * (nq - 1) / denom)
    raw = np.log(np.expm1(0.693147 * np.sqrt(lam / mid))).astype(np.float32)
    e = params["quant_embed"]["e"].clone()
    e[:, :nb] = torch.as_tensor(raw, device=e.device)[:, None]
    return {**params, "quant_embed": {"e": e}}


# the encoder's three GRUs and the dense layer after each
_GRUS = (("gru2", "dense3"), ("gru4", "dense5"), ("gru6", "dense7"))


def _stack(p, x, h0s, ap, first=None):
    """The 8-layer stack shared by encoder and decoder: dense, GRU, dense,
    GRU, dense, GRU, dense, dense, each layer's output kept; h0s are the
    three GRUs' initial states, first (where given) their first recurrent
    preactivations (recurrent_products). Returns the concat (B, T,
    concat_size)."""
    outs = [layers.dense_apply(p["dense1"], x, "tanh", ap)]
    for i, (gru, dense) in enumerate(_GRUS):
        outs.append(layers.gru_sequence(
            p[gru], outs[-1], h0s[i], approx=ap,
            first=None if first is None else first[i]))
        outs.append(layers.dense_apply(p[dense], outs[-1], "tanh", ap))
    outs.append(layers.dense_apply(p["dense8"], outs[-1], "tanh", ap))
    return torch.cat(outs, dim=-1)


def encode_stack(params, feats: torch.Tensor, gru: torch.Tensor,
                 cfg: RDOVAEConfig = RDOVAEConfig(), first=None):
    """The encoder's stack over feats (B, T, 20), T even, from the GRU
    states gru (B, 3, cond_size) and, where given, their first recurrent
    preactivations first (3, B, 3 cond_size; recurrent_products). Returns
    (the concat (B, T/2, concat_size), one row per feature pair; the GRU
    states after the last pair (B, 3, cond_size), read from the concat's
    last row)."""
    refuse_tf32(feats, "the RDO-VAE encoder's products (TF32 flips DRED "
                "symbols)")
    B, T, F = feats.shape
    pre = _stack(params["enc"], feats.reshape(B, T // 2, 2 * F),
                 gru.unbind(1), cfg.approx, first)
    c, c2 = cfg.cond_size, cfg.cond_size2
    # the concat's columns: dense1 (c2), gru2 (c), dense3 (c2), gru4 (c),
    # dense5 (c2), gru6 (c), dense7, dense8
    last = pre[:, -1]
    return pre, torch.stack([last[:, (i + 1) * c2 + i * c:
                                  (i + 1) * (c2 + c)] for i in range(3)],
                            dim=1)


def recurrent_products(params, gru: torch.Tensor, out: torch.Tensor) -> None:
    """The encoder's GRUs' first recurrent preactivations h @ wr + br from
    their states gru (B, 3, cond_size), which need no features: written
    into out (3, B, 3 cond_size)."""
    refuse_tf32(gru, "the RDO-VAE encoder's products (TF32 flips DRED "
                "symbols)")
    p = params["enc"]
    for i, (g, _) in enumerate(_GRUS):
        torch.add(gru[:, i] @ p[g]["wr"], p[g]["br"], out=out[i])


def encode(params, feats: torch.Tensor, cfg: RDOVAEConfig = RDOVAEConfig()):
    """feats: (B, T, 20) with T even -> (z (B, T/2, 80), state (B, T/2,
    24)), one latent per feature pair (rdovae.py:257-329); the dframe rate
    is every second one (DREDCodec)."""
    p = params["enc"]
    ap = cfg.approx
    B, T, F = feats.shape
    pre, _ = encode_stack(params, feats,
                          feats.new_zeros((B, 3, cfg.cond_size)), cfg)
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


def conv_taps(params) -> torch.Tensor:
    """The causal conv's four taps w0..w3 regrouped for a dframe's two
    pairs: (2 * concat_size, 2 * nb_latents), the rows [w0 | w2] of the
    first pair over the rows [w1 | w3] of the second, so that the two
    pairs' concat rows side by side, times it, give [the dframe's share
    of the next dframe's latent | its share of its own]."""
    w = params["enc"]["bits_conv"]["w"]
    return torch.cat([torch.cat([w[0], w[2]], dim=1),
                      torch.cat([w[1], w[3]], dim=1)], dim=0).contiguous()


def encode_heads(params, taps: torch.Tensor, carry: torch.Tensor,
                 pre: torch.Tensor, cfg: RDOVAEConfig = RDOVAEConfig()):
    """The latent and state heads of k dframes, streaming: pre (B, 2k,
    concat_size) from encode_stack, taps from conv_taps, carry (B,
    nb_latents) the previous dframe's share of the first latent (zero at
    a stream's start, as encode's causal padding). The conv's output at a
    dframe's second pair t takes pairs t-3..t (encode's causal conv,
    evaluated at the pairs encode keeps); the state head reads the second
    pair. Returns (latents (B, k, 80), states (B, k, 24) before PVQ, the
    carry for the next call (B, nb_latents))."""
    ap = cfg.approx
    B, T, C = pre.shape
    nl = cfg.nb_latents
    y = pre.reshape(B, T // 2, 2 * C) @ taps
    early, late = y[..., :nl], y[..., nl:]
    before = torch.cat([carry[:, None], early[:, :-1]], dim=1)
    z = before + late + params["enc"]["bits_conv"]["b"]
    g = layers.dense_apply(params["enc"]["gdense1"], pre[:, 1::2], "tanh", ap)
    state = layers.dense_apply(params["enc"]["gdense2"], g, "tanh", ap)
    return z, state, early[:, -1]


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


class _Softplus(torch.autograd.Function):
    """log(1 + exp(x)) in jax.nn.softplus's form, logaddexp(x, 0), with
    its gradient sigmoid(x) everywhere. Differentiated term by term, the
    form would send 1 back at x = 0 (torch's clamp and abs pass 1 and 0
    at the tie), twice sigmoid(0); the quant embedding starts at exactly
    0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


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


def hard_quantize(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient (rdovae.py:97-100)."""
    return x + (torch.round(x) - x).detach()


def noise_quantize(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Additive U(-.5, .5) quantization noise (uniform_noise.py:53-66),
    drawn from gen on x's device."""
    return x + (torch.rand(x.shape, generator=gen, device=x.device) - 0.5)


def pvq_quantize(x: torch.Tensor, k: int, iters: int = 10) -> torch.Tensor:
    """Unit-norm PVQ with k pulses and a straight-through gradient
    (rdovae.py:210-247): xn + (q - xn) with q - xn detached, rounded as the
    JAX package rounds; the gradient is that of the normalised input xn.
    x: (..., D)."""
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
    return xn + (q - xn).detach()


# ------------------------------------------------------------------ losses

_LOG2_E = 1.4427
_EPS = 1e-6


def _safelog2(x):
    return _LOG2_E * torch.log(_EPS + x)


def feat_dist_loss(y_true, y_pred, lam):
    """Lambda-weighted cepstral/pitch/corr distortion (rdovae.py:129-146).
    y_true, y_pred: (..., T, 20); lam: (..., T, 1)."""
    lambda_1 = 1.0 / torch.sqrt(lam[..., 0])
    ceps = y_pred[..., :18] - y_true[..., :18]
    pitch = 2.0 * (y_pred[..., 18:19] - y_true[..., 18:19]) \
        / (y_true[..., 18:19] + 2.0)
    corr = y_pred[..., 19:] - y_true[..., 19:]
    pitch_weight = torch.square(ties.maximum(y_true[..., 19:] + 0.5, 0.0))
    inner = torch.mean(torch.square(ceps), dim=-1) \
        + 10.0 * (1 / 18.0) * torch.mean(ties.abs(pitch) * pitch_weight,
                                          dim=-1) \
        + (1 / 18.0) * torch.mean(torch.square(corr), dim=-1)
    return torch.mean(lambda_1 * inner)


def _rate(z, r, p0):
    """Entropy model -log2 P(z) of integer symbols z (sq2_rate_loss's
    body)."""
    az = ties.abs(z)
    y0 = ties.maximum(1.0 - az, 0.0) ** 2
    return (-y0 * _safelog2(p0 * r ** az)
            - (1 - y0) * _safelog2(0.5 * (1 - p0) * (1 - r)
                                   * r ** (az - 1.0)))


def _entropy_params(q):
    """(p0, r) of the soft or hard entropy-model parameters (..., 160)."""
    n = q.shape[-1] // 2
    r = q[..., n:]
    return 1.0 - r ** (0.5 + 0.5 * q[..., :n]), r


def sq1_rate_loss(z, soft, lam):
    """Soft (continuous) rate loss (rdovae.py:149-170). z: (B, S, 80)
    dead-zoned unrounded symbols; soft: (B, S, 160); lam: (B, S, 1)."""
    _, r = _entropy_params(soft)
    rate = -_safelog2((1 - r) / (1 + r) * r ** ties.abs(z))
    return torch.mean(torch.sqrt(lam[..., 0]) * torch.sum(rate, dim=-1))


def sq2_rate_loss(z, hard, lam):
    """Hard (rounded) rate loss (rdovae.py:173-187)."""
    p0, r = _entropy_params(hard)
    rate = _rate(torch.round(z), r, p0)
    return torch.mean(torch.sqrt(lam[..., 0]) * torch.sum(rate, dim=-1))


def sq_rate_metric(z, hard):
    """Bits-per-step estimate of rounded symbols (rdovae.py:190-207)."""
    p0, r = _entropy_params(hard)
    return torch.mean(torch.sum(_rate(torch.round(z), r, p0), dim=-1))
