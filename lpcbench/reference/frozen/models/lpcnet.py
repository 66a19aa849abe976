"""LPCNet vocoder model: the frame-rate conditioning net and the tables of
the sample-rate net (the port of lpcnet_tpu/models/lpcnet.py; reference
training model training_tf2/lpcnet.py:312-475, C engine src/lpcnet.c).

Parameters are the JAX package's pytree as a nested dict of float32
tensors (see convert.params_from_numpy):
  embed_pitch : Embedding(256, 64)         conv1/conv2 : Conv1D(cond, k=3)
  dense1/2    : Dense(cond, tanh)          embed_sig   : Embedding(256, 128)
  gru_a       : GRU(384), input 3*128 + cond
  gru_b       : GRU(16),  input 384 + cond
  dual_fc     : MDense(256, 2 channels)
"""
import dataclasses
from typing import Any, Dict, Optional

import torch

from ..constants import (COND_SIZE, DUAL_FC_OUT, EMBED_PITCH_SIZE,
                         EMBED_SIG_SIZE, FEATURES_DELAY, FRAME_SIZE,
                         GRU_A_SIZE, GRU_B_SIZE, LPC_ORDER, NB_BANDS,
                         NB_FEATURES, PREEMPHASIS)
from ..ops import dsp
from . import layers


@dataclasses.dataclass(frozen=True)
class LPCNetConfig:
    gru_a_units: int = GRU_A_SIZE
    gru_b_units: int = GRU_B_SIZE
    cond_size: int = COND_SIZE
    embed_sig_size: int = EMBED_SIG_SIZE
    embed_pitch_size: int = EMBED_PITCH_SIZE
    pcm_levels: int = DUAL_FC_OUT
    nb_features: int = NB_FEATURES
    lpc_order: int = LPC_ORDER
    frame_size: int = FRAME_SIZE
    lpc_gamma: float = 1.0      # bandwidth expansion (lpcnet.c:116-118)
    e2e: bool = False           # rc2lpc end-to-end mode (lpcnet.c:56-79)
    lookahead: int = FEATURES_DELAY
    approx: bool = False        # use reference table activations
    preemph: float = PREEMPHASIS  # PREEMPH (lpcnet.c:40)

    @property
    def rnn_in_size(self) -> int:
        return 3 * self.embed_sig_size + self.cond_size  # 512

    @property
    def frame_in_size(self) -> int:
        return self.nb_features + self.embed_pitch_size  # 84


def init_params(gen: torch.Generator, cfg: LPCNetConfig) -> Dict[str, Any]:
    """A fresh parameter tree (lpcnet_tpu/models/lpcnet.py::init_params):
    float32 tensors on the CPU drawn from gen."""
    na, nc = cfg.gru_a_units, cfg.cond_size
    return {
        "embed_pitch": layers.embedding_init(gen, cfg.pcm_levels,
                                             cfg.embed_pitch_size, 0.1),
        "conv1": layers.conv1d_init(gen, cfg.frame_in_size, nc, 3),
        "conv2": layers.conv1d_init(gen, nc, nc, 3),
        "dense1": layers.dense_init(gen, nc, nc),
        "dense2": layers.dense_init(gen, nc, nc),
        "embed_sig": layers.embedding_init(gen, cfg.pcm_levels,
                                           cfg.embed_sig_size, 0.1),
        "gru_a": layers.gru_init(gen, cfg.rnn_in_size, na),
        "gru_b": layers.gru_init(gen, na + nc, cfg.gru_b_units),
        "dual_fc": layers.dualfc_init(gen, cfg.gru_b_units, cfg.pcm_levels),
    }


def pitch_index(features: torch.Tensor) -> torch.Tensor:
    """Quantize the pitch feature to an embedding index (lpcnet.c:92-94):
    floor(.1 + 50*f[NB_BANDS] + 100), clamped to [33, 255]."""
    p = torch.floor(0.1 + 50.0 * features[..., NB_BANDS] + 100.0)
    return torch.clamp(p, 33, 255).to(torch.int32)


def frame_features_net(params, features, pitch_idx, cfg: LPCNetConfig):
    """Frame-rate conditioning over a chunk: (B, T, 20+) -> cfeat
    (B, T, cond), with 'same'-padded convs as in the training graph."""
    ap = cfg.approx
    pe = layers.embedding_apply(params["embed_pitch"], pitch_idx)
    x = torch.cat([features[..., :cfg.nb_features], pe], dim=-1)
    x = layers.conv1d_same_apply(params["conv1"], x, "tanh", ap)
    x = layers.conv1d_same_apply(params["conv2"], x, "tanh", ap)
    x = layers.dense_apply(params["dense1"], x, "tanh", ap)
    return layers.dense_apply(params["dense2"], x, "tanh", ap)


def precompute_sample_tables(params, cfg: LPCNetConfig) -> Dict[str, Any]:
    """Fold the shared mu-law embedding through GRU-A's input kernel into
    three per-value additive tables and split the condition kernels
    (training_tf2/dump_lpcnet.py:450-469). Returns the dict the sample loop
    (kernels.sample_scan, kernels.sample_cuda) consumes."""
    es = cfg.embed_sig_size
    wi_a = params["gru_a"]["wi"]           # (3*es + cond, 3*Na)
    e = params["embed_sig"]["e"]           # (256, es)
    wi_b = params["gru_b"]["wi"]           # (Na + cond, 3*Nb)
    return {
        "tbl_sig": e @ wi_a[:es], "tbl_pred": e @ wi_a[es:2 * es],
        "tbl_exc": e @ wi_a[2 * es:3 * es],
        "cond_a_w": wi_a[3 * es:], "bi_a": params["gru_a"]["bi"],
        "wr_a": params["gru_a"]["wr"], "br_a": params["gru_a"]["br"],
        "wi_b": wi_b[:cfg.gru_a_units].contiguous(),
        "cond_b_w": wi_b[cfg.gru_a_units:], "bi_b": params["gru_b"]["bi"],
        "wr_b": params["gru_b"]["wr"], "br_b": params["gru_b"]["br"],
        "dual_fc": params["dual_fc"],
    }


def frame_conditions(params, features, cfg: LPCNetConfig,
                     tables: Optional[Dict[str, Any]] = None):
    """Per-frame conditioning for synthesis.

    features: (B, T, >=20). Returns dict with cond_a (B,T,3Na), cond_b
    (B,T,3Nb), lpc (B,T,16) and cfeat. LPC comes from the cepstrum
    (lpcnet.c:109-115) unless cfg.e2e (rc2lpc of dense2's first outputs)."""
    if tables is None:
        tables = precompute_sample_tables(params, cfg)
    cfeat = frame_features_net(params, features, pitch_index(features), cfg)
    cond_a = cfeat @ tables["cond_a_w"] + tables["bi_a"]
    cond_b = cfeat @ tables["cond_b_w"] + tables["bi_b"]
    if cfg.e2e:
        lpc = rc2lpc(cfeat[..., :cfg.lpc_order])
    else:
        lpc, _ = dsp.lpc_from_cepstrum(features[..., :NB_BANDS])
    if cfg.lpc_gamma != 1.0:
        lpc = dsp.lpc_weighting(lpc, cfg.lpc_gamma)
    return {"cond_a": cond_a, "cond_b": cond_b, "lpc": lpc, "cfeat": cfeat}


def frame_net_init_state(batch: int, cfg: LPCNetConfig, device=None):
    """Streaming frame-network state: the conv delay lines and the LPC
    delay line (NNetState + old_lpc, lpcnet_private.h:33-47). With
    cfg.lookahead == 0, old_lpc is an empty (B, 0, 16) tensor."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv1_mem": torch.zeros((batch, 2, cfg.frame_in_size), **f32),
        "conv2_mem": torch.zeros((batch, 2, cfg.cond_size), **f32),
        "old_lpc": torch.zeros((batch, cfg.lookahead, cfg.lpc_order), **f32),
        "frame_count": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
    }


def frame_net_step(params, tables, fstate, features, cfg: LPCNetConfig):
    """One streaming frame-conditioning step (run_frame_network,
    lpcnet.c:82-120): causal convs with warm-up zeroing and the
    FEATURES_DELAY LPC delay line. features: (B, >=20). Returns
    (new_fstate, dict with cond_a, cond_b, lpc aligned to the conv-delayed
    conditions, and cfeat)."""
    ap = cfg.approx
    pe = layers.embedding_apply(params["embed_pitch"], pitch_index(features))
    x = torch.cat([features[..., :cfg.nb_features], pe], dim=-1)
    c1, c1_mem = layers.conv1d_step(params["conv1"], fstate["conv1_mem"], x,
                                    "tanh", ap)
    fc = fstate["frame_count"]
    c1 = torch.where((fc < 1)[:, None], 0.0, c1)             # lpcnet.c:99
    c2, c2_mem = layers.conv1d_step(params["conv2"], fstate["conv2_mem"], c1,
                                    "tanh", ap)
    c2 = torch.where((fc < cfg.lookahead)[:, None], 0.0, c2)  # lpcnet.c:101
    h = layers.dense_apply(params["dense1"], c2, "tanh", ap)
    cfeat = layers.dense_apply(params["dense2"], h, "tanh", ap)
    cond_a = cfeat @ tables["cond_a_w"] + tables["bi_a"]
    cond_b = cfeat @ tables["cond_b_w"] + tables["bi_b"]
    old_lpc = fstate["old_lpc"]
    if cfg.e2e:
        lpc = rc2lpc(cfeat[..., :cfg.lpc_order])
    elif cfg.lookahead == 0:
        # no-lookahead models use the current frame's LPC directly
        lpc, _ = dsp.lpc_from_cepstrum(features[..., :NB_BANDS])
    else:
        # LPC delayed by FEATURES_DELAY frames (lpcnet.c:109-115)
        new_lpc, _ = dsp.lpc_from_cepstrum(features[..., :NB_BANDS])
        lpc = old_lpc[:, -1]
        old_lpc = torch.cat([new_lpc[:, None], old_lpc[:, :-1]], dim=1)
    if cfg.lpc_gamma != 1.0:
        lpc = dsp.lpc_weighting(lpc, cfg.lpc_gamma)
    new_fstate = {"conv1_mem": c1_mem, "conv2_mem": c2_mem,
                  "old_lpc": old_lpc,
                  "frame_count": torch.clamp(fc + 1, max=1000)}
    return new_fstate, {"cond_a": cond_a, "cond_b": cond_b, "lpc": lpc,
                        "cfeat": cfeat}


def rc2lpc(rc: torch.Tensor) -> torch.Tensor:
    """Reflection coefficients -> LPC by the step-up recursion
    (lpcnet.c:56-79). rc: (..., order)."""
    order = rc.shape[-1]
    lpc = rc.clone()
    for i in range(1, order):
        # a_j += a_i * a_{i-1-j} for j < i, using pre-update values
        upd = lpc[..., :i] + lpc[..., i:i + 1] * lpc[..., :i].flip(-1)
        lpc = torch.cat([upd, lpc[..., i:]], dim=-1)
    return lpc
