"""PLC feature-prediction network (the port of lpcnet_tpu/models/plc.py;
reference training_tf2/lpcnet_plc.py:94-181, C engine compute_plc_pred
src/lpcnet_plc.c:135-145).

Topology: Dense(128, tanh) -> GRU(256) -> GRU(256) -> Dense(20, linear).
Input per frame: [burg cepstra (36) | features (20) | lost flag (1)] = 57.
The lost flag encodes {1: good frame with Burg, 0: lost, -1: good via FEC
without Burg} (plc_loader.py:56-89, lpcnet_plc.c:153-166).
"""
import dataclasses

import torch

from ..constants import NB_BANDS, NB_FEATURES, PLC_DENSE_SIZE, PLC_GRU_SIZE
from . import layers

PLC_INPUT_SIZE = 2 * NB_BANDS + NB_FEATURES + 1  # 57


@dataclasses.dataclass(frozen=True)
class PLCConfig:
    dense_size: int = PLC_DENSE_SIZE
    gru_size: int = PLC_GRU_SIZE
    nb_features: int = NB_FEATURES
    approx: bool = False


def init_net_state(batch: int, cfg: PLCConfig = PLCConfig(), device=None):
    return {k: torch.zeros((batch, cfg.gru_size), dtype=torch.float32,
                           device=device) for k in ("gru1", "gru2")}


def step(params, net_state, x, cfg: PLCConfig = PLCConfig()):
    """One prediction step (compute_plc_pred, lpcnet_plc.c:135-145).

    x: (B, 57). Returns (new_net_state, predicted features (B, 20)) with
    the reference's correlation boost out[19] = min(.5, out[19]+.1)."""
    ap = cfg.approx
    h = layers.dense_apply(params["dense1"], x, "tanh", ap)
    g1 = layers.gru_apply(params["gru1"], net_state["gru1"], h, "tanh", ap)
    g2 = layers.gru_apply(params["gru2"], net_state["gru2"], g1, "tanh", ap)
    out = layers.dense_apply(params["out"], g2, "linear", ap)
    boost = torch.clamp(out[..., 19:] + 0.1, max=0.5)
    return {"gru1": g1, "gru2": g2}, torch.cat([out[..., :19], boost], -1)


def forward_sequence(params, xs, cfg: PLCConfig = PLCConfig(),
                     net_state=None):
    """The training-time forward over (B, T, 57) -> (B, T, 20), WITHOUT the
    inference-only correlation boost of step (the Keras training graph,
    lpcnet_plc.py:94-181)."""
    ap = cfg.approx
    if net_state is None:
        net_state = init_net_state(xs.shape[0], cfg, xs.device)
    h = layers.dense_apply(params["dense1"], xs, "tanh", ap)
    g1 = layers.gru_sequence(params["gru1"], h, net_state["gru1"], approx=ap)
    g2 = layers.gru_sequence(params["gru2"], g1, net_state["gru2"],
                             approx=ap)
    return layers.dense_apply(params["out"], g2, "linear", ap)
