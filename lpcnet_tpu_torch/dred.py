"""DRED application layer: encode feature redundancy, decode on loss (the
port of lpcnet_tpu/dred.py; reference training_tf2/fec_encoder.py:200-305,
C inference src/dred_rdovae.c).

Features are encoded to 50 Hz latents; a redundancy payload for packet n
carries the latents of the last `num_dframes` 20-ms dframes, quantized
with per-position quantizers that get coarser with age (quant_id_ramp),
plus the PVQ-quantized decoder resume state of the oldest dframe. On loss,
the decoder rebuilds the feature history from the latest payload received.

    params, cfg = convert.load_dred()          # shipped weights, the card
    dc = DREDCodec(params, cfg)
    zd, sd = dc.encode(feats20)                # (B, T, 20), T % 4 == 0
    sym, qid = dc.quantize_payload(zd[:, :s])  # payload of packet s
    feats = dc.decode(sym, qid, sd[:, s - n])  # (B, 4n, 20), oldest first
"""
import dataclasses

import numpy as np
import torch

from . import convert
from .device import resolve_device
from .models import rdovae as rv


@dataclasses.dataclass(frozen=True)
class DREDConfig:
    num_dframes: int = 16          # redundancy span: 16 * 20 ms = 320 ms
    # a high q is a high lambda and a low rate, so q3 is the fine end and
    # q15 the coarse end; the newest dframe is the finest
    # (fec_encoder.py:200-209, :242-243)
    q0: int = 3                    # newest dframe's quant level
    q1: int = 15                   # oldest dframe's quant level


def quant_id_ramp(cfg: DREDConfig) -> np.ndarray:
    """Per-position quantizer ids, newest -> oldest (fec_encoder.py:200-209:
    older redundancy is coarser; ids index the lambda embedding). np.round
    rounds half to even, as jnp.round and torch.round do."""
    i = np.arange(cfg.num_dframes, dtype=np.float32)
    ramp = cfg.q0 + (cfg.q1 - cfg.q0) * i / max(1, cfg.num_dframes - 1)
    return np.round(ramp).astype(np.int32)


class DREDCodec:
    def __init__(self, params, cfg: rv.RDOVAEConfig = rv.RDOVAEConfig(),
                 dred_cfg: DREDConfig = DREDConfig(), device=None):
        """params: the port's RDO-VAE parameter dict (convert.load_dred).
        device: None means the card, and raises where there is none."""
        self.device = resolve_device(device)
        self.params = convert.to_device(params, self.device)
        self.cfg = cfg
        self.dred = dred_cfg
        # the payload's quant ids, newest first, uploaded once
        self.qid = torch.as_tensor(quant_id_ramp(dred_cfg), device=self.device)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode(self, feats):
        """feats: (B, T, 20), T % 4 == 0. Returns the per-dframe latents
        zd (B, T/4, 80) and the PVQ-quantized resume states sd
        (B, T/4, 24)."""
        z, state = rv.encode(self.params, self._f32(feats), self.cfg)
        # dframe rate: every second pair step, the one ending the dframe
        return z[:, 1::2], rv.pvq_quantize(state[:, 1::2], self.cfg.pvq_k)

    @torch.no_grad()
    def quantize_payload(self, zd):
        """Quantize the last num_dframes latents with the age ramp.
        zd: (B, S, 80) with S >= num_dframes. Returns (symbols (B, n, 80)
        int32, newest first; the quant ids used (n,) int32)."""
        tail = torch.flip(self._f32(zd)[:, -self.dred.num_dframes:], [1])
        qp = rv.quant_params(self.params, self.qid, self.cfg)
        dze = rv.apply_dead_zone(tail * qp["scale"], qp["dead_zone"])
        return torch.round(dze).to(torch.int32), self.qid

    @torch.no_grad()
    def decode(self, sym, qid, state):
        """Features from a redundancy payload. sym: (B, n, 80) symbols,
        newest first; qid: (n,) quant ids; state: (B, 24) resume state of
        the oldest dframe. Returns (B, n*4, 20) features, oldest first
        (DRED_rdovae_decode_all, src/dred_rdovae.c:38-52)."""
        qp = rv.quant_params(self.params,
                             torch.as_tensor(qid, device=self.device),
                             self.cfg)
        z = self._f32(sym) / qp["scale"]
        return rv.decode(self.params, torch.flip(z, [1]), self._f32(state),
                         self.cfg)


@torch.no_grad()
def roundtrip_rms(params, cfg: rv.RDOVAEConfig, feats: torch.Tensor,
                  quant: int = 0) -> float:
    """The RDO-VAE's quality measure (the recipe of the JAX package's
    shipped-weights test, tests/test_rdovae.py:150-181): encode feats
    (B, T, 20), T % 8 == 0; every second latent and PVQ state; symbols of
    every dframe at level `quant`; decode the whole sequence from the first
    state. Returns the RMS of the decoded features against feats."""
    z, state = rv.encode(params, feats, cfg)
    zd, sd = z[:, 1::2], rv.pvq_quantize(state[:, 1::2], cfg.pvq_k)
    qp = rv.quant_params(params, torch.full(zd.shape[:2], quant,
                                            device=zd.device), cfg)
    sym = torch.round(rv.apply_dead_zone(zd * qp["scale"], qp["dead_zone"]))
    out = rv.decode(params, sym / qp["scale"], sd[:, 0], cfg)
    n = min(out.shape[1], feats.shape[1])
    return float(torch.sqrt(torch.mean((out[:, :n] - feats[:, :n]) ** 2)))
