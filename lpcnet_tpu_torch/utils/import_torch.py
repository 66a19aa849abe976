"""Reference torch-trained RDO-VAE checkpoints into the port (the port's
copy of lpcnet_tpu/utils/import_torch.py).

The reference's DRED trainer is PyTorch (torch/rdovae/train_rdovae.py:
179-215 saves {'state_dict', 'model_args': (num_features, latent_dim,
quant_levels, cond_size, cond_size2), 'model_kwargs': {state_dim, ...}}).
Its interchange paths are (a) that checkpoint dict itself and (b) the
wexchange numpy export directory (export_rdovae_weights.py:258-293: one
subdirectory per layer, named by the exchange names of
import_rdovae_weights.py:77-103, holding raw torch arrays as .npy). Both
become the numpy parameter tree of models/rdovae.py (convert.load_dred
puts it on a device).

Weight-layout transforms:
  * torch nn.Linear: weight (out, in) -> dense w (in, out).
  * torch nn.GRU: weight_ih_l0/weight_hh_l0 are (3N, in)/(3N, N) in gate
    order [r, z, n]; ours is (in, 3N)/(N, 3N) in order [z, r, h]
    -> transpose + block reorder. torch's n-gate
    n = tanh(Wx + bi + r*(Wh h + bh)) is layers.gru_gates' reset-after
    form, so the reorder is the whole transform.
  * torch nn.Conv1d: weight (out, in, k) -> TIO (k, in, out); both sides
    compute a causal cross-correlation with k-1 left padding.
  * statistical_model.quant_embedding (quant_levels, 6*latent_dim) copies
    verbatim: [scale, dead_zone, theta_soft, r_soft, theta_hard, r_hard].

The torch CoreDecoder's dense_4/dense_5 are (cond_size -> cond_size2 ->
cond_size2) where the TF decoder uses (c -> c -> c); decode() takes the
widths the tree carries, so both geometries run.
"""
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.rdovae import RDOVAEConfig

# our param key -> torch submodule name (import_rdovae_weights.py:77-103)
_ENC_MAP = {
    "dense1": "dense_1", "gru2": "gru_1", "dense3": "dense_2",
    "gru4": "gru_2", "dense5": "dense_3", "gru6": "gru_3",
    "dense7": "dense_4", "dense8": "dense_5",
    "gdense1": "state_dense_1", "gdense2": "state_dense_2",
}
_DEC_MAP = {
    "dense1": "dense_1", "gru2": "gru_1", "dense3": "dense_2",
    "gru4": "gru_2", "dense5": "dense_3", "gru6": "gru_3",
    "dense7": "dense_4", "dense8": "dense_5", "final": "output",
    "state1": "gru_1_init", "state2": "gru_2_init", "state3": "gru_3_init",
}
# torch submodule -> wexchange numpy-export directory name
# (export_rdovae_weights.py numpy_export / import_rdovae_weights.py)
_EXCHANGE_NAMES = {
    "core_encoder.module.dense_1": "encoder_stack_layer1_dense",
    "core_encoder.module.dense_2": "encoder_stack_layer3_dense",
    "core_encoder.module.dense_3": "encoder_stack_layer5_dense",
    "core_encoder.module.dense_4": "encoder_stack_layer7_dense",
    "core_encoder.module.dense_5": "encoder_stack_layer8_dense",
    "core_encoder.module.state_dense_1": "encoder_state_layer1_dense",
    "core_encoder.module.state_dense_2": "encoder_state_layer2_dense",
    "core_encoder.module.gru_1": "encoder_stack_layer2_gru",
    "core_encoder.module.gru_2": "encoder_stack_layer4_gru",
    "core_encoder.module.gru_3": "encoder_stack_layer6_gru",
    "core_encoder.module.conv1": "encoder_stack_layer9_conv",
    "statistical_model.quant_embedding": "statistical_model_embedding",
    "core_decoder.module.gru_1_init": "decoder_state1_dense",
    "core_decoder.module.gru_2_init": "decoder_state2_dense",
    "core_decoder.module.gru_3_init": "decoder_state3_dense",
    "core_decoder.module.dense_1": "decoder_stack_layer1_dense",
    "core_decoder.module.dense_2": "decoder_stack_layer3_dense",
    "core_decoder.module.dense_3": "decoder_stack_layer5_dense",
    "core_decoder.module.dense_4": "decoder_stack_layer7_dense",
    "core_decoder.module.dense_5": "decoder_stack_layer8_dense",
    "core_decoder.module.output": "decoder_stack_layer9_dense",
    "core_decoder.module.gru_1": "decoder_stack_layer2_gru",
    "core_decoder.module.gru_2": "decoder_stack_layer4_gru",
    "core_decoder.module.gru_3": "decoder_stack_layer6_gru",
}


def _rzn_to_zrh(a: np.ndarray) -> np.ndarray:
    """Reorder torch's [r, z, n] gate blocks (leading axis) to [z, r, h]."""
    n = a.shape[0] // 3
    return np.concatenate([a[n:2 * n], a[:n], a[2 * n:]], axis=0)


def _dense(w: np.ndarray, b: np.ndarray) -> Dict[str, np.ndarray]:
    return {"w": np.ascontiguousarray(w.T.astype(np.float32)),
            "b": b.astype(np.float32)}


def _gru(w_ih, w_hh, b_ih, b_hh) -> Dict[str, np.ndarray]:
    return {
        "wi": np.ascontiguousarray(_rzn_to_zrh(w_ih).T.astype(np.float32)),
        "wr": np.ascontiguousarray(_rzn_to_zrh(w_hh).T.astype(np.float32)),
        "bi": _rzn_to_zrh(b_ih).astype(np.float32),
        "br": _rzn_to_zrh(b_hh).astype(np.float32),
    }


def _conv(w: np.ndarray, b: np.ndarray) -> Dict[str, np.ndarray]:
    return {"w": np.ascontiguousarray(
                np.transpose(w, (2, 1, 0)).astype(np.float32)),
            "b": b.astype(np.float32)}


def _params_from_getters(get):
    """The parameter tree, given get(torch_name, tensor_name) -> array."""
    def dense(mod):
        return _dense(get(mod, "weight"), get(mod, "bias"))

    def gru(mod):
        return _gru(get(mod, "weight_ih_l0"), get(mod, "weight_hh_l0"),
                    get(mod, "bias_ih_l0"), get(mod, "bias_hh_l0"))

    enc: Dict[str, Any] = {}
    for ours, theirs in _ENC_MAP.items():
        mod = f"core_encoder.module.{theirs}"
        enc[ours] = gru(mod) if ours.startswith("gru") else dense(mod)
    cw = get("core_encoder.module.conv1", "weight")
    cb = get("core_encoder.module.conv1", "bias")
    enc["bits_conv"] = _conv(cw, cb)
    dec: Dict[str, Any] = {}
    for ours, theirs in _DEC_MAP.items():
        mod = f"core_decoder.module.{theirs}"
        dec[ours] = gru(mod) if ours.startswith("gru") else dense(mod)
    quant = {"e": get("statistical_model.quant_embedding", "weight")
             .astype(np.float32)}
    return {"enc": enc, "dec": dec, "quant_embed": quant}


def import_rdovae_torch(path: str) -> Tuple[Dict[str, Any], RDOVAEConfig]:
    """Load a reference torch training checkpoint (train_rdovae.py:179-215)
    into (numpy parameter tree, RDOVAEConfig)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().cpu().numpy()
          for k, v in ckpt["state_dict"].items()}
    nf, latent_dim, quant_levels, cond, cond2 = ckpt["model_args"]
    kw = ckpt.get("model_kwargs", {})
    cfg = RDOVAEConfig(
        nb_features=nf, nb_latents=latent_dim, nb_quant=quant_levels,
        cond_size=cond, cond_size2=cond2,
        state_dim=kw.get("state_dim", 24),
        pvq_k=kw.get("pvq_num_pulses", 82))

    def get(mod, tensor):
        key = f"{mod}.{tensor}"
        if key not in sd:
            raise KeyError(f"torch checkpoint: missing '{key}'")
        return sd[key]

    return _params_from_getters(get), cfg


def import_rdovae_numpy_dir(path: str) -> Tuple[Dict[str, Any],
                                                RDOVAEConfig]:
    """Load a wexchange numpy-export directory
    (export_rdovae_weights.py:258-293) into (params, RDOVAEConfig).
    The directory holds one subdir per layer with raw torch arrays:
    dense weight.npy (out, in) + bias.npy; GRU weight_ih_rzn.npy (3N, in)
    etc.; conv weight_oik.npy (out, in, k); embedding weight.npy.
    Hyperparameters are not stored in the export — they are inferred from
    the array shapes."""
    npy_names = {"weight_ih_l0": "weight_ih_rzn", "weight_hh_l0":
                 "weight_hh_rzn", "bias_ih_l0": "bias_ih_rzn",
                 "bias_hh_l0": "bias_hh_rzn"}

    def get(mod, tensor):
        d = os.path.join(path, _EXCHANGE_NAMES[mod])
        name = npy_names.get(tensor, tensor)
        if mod.endswith("conv1") and tensor == "weight":
            name = "weight_oik"
        f = os.path.join(d, name + ".npy")
        if not os.path.exists(f):
            raise FileNotFoundError(f"numpy exchange dir: missing {f}")
        return np.load(f)

    params = _params_from_getters(get)
    emb = params["quant_embed"]["e"]
    cfg = RDOVAEConfig(
        nb_features=params["dec"]["final"]["b"].shape[0] // 4,
        nb_latents=params["enc"]["bits_conv"]["b"].shape[0],
        nb_quant=emb.shape[0],
        cond_size=params["enc"]["gru2"]["wr"].shape[0],
        cond_size2=params["enc"]["dense1"]["b"].shape[0],
        state_dim=params["enc"]["gdense2"]["b"].shape[0])
    return params, cfg
