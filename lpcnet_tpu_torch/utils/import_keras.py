"""Reference Keras .h5 checkpoints into the port (the port's copy of
lpcnet_tpu/utils/import_keras.py).

The reference trains with TF2/Keras (training_tf2/train_lpcnet.py,
train_plc.py). These readers turn its .h5 files into the numpy parameter
trees of models/lpcnet.py and models/plc.py; convert.load_lpcnet_model and
load_plc_model put them on a device.

Layer-name map (training_tf2/lpcnet.py:312-439, lpcnet_plc.py:94-181):
  embed_pitch, feature_conv1/2, feature_dense1/2, embed_sig, gru_a, gru_b,
  dual_fc    -> models/lpcnet.py parameter keys
  plc_dense1, plc_gru1, plc_gru2, plc_out -> models/plc.py parameter keys

Weight-layout transforms:
  * Keras GRU (reset_after): kernel (in, 3N), recurrent_kernel (N, 3N),
    bias (2, 3N) = [input bias, recurrent bias]; gate order [z, r, h] is
    layers.gru_gates' and the C runtime's (nnet.c:281-322).
  * MDense 'dual_fc': kernel (256, 16, 2) -> ours (2, 16, 256);
    bias/factor (256, 2) -> (2, 256) (mdense.py:46-70).
  * Scalar hyperparameters (lpc_gamma, lookahead, flag_e2e) are stored as
    extra weights (parameters.py:6-42) and read into LPCNetConfig.

h5py is imported by the readers alone; where it is not installed they
raise an ImportError that names it.
"""
from typing import Dict

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading a Keras .h5 checkpoint needs the h5py "
                          "package, which is not installed") from e
    return h5py


def _collect(h5group, out, prefix=""):
    h5py = _h5py()
    for k, v in h5group.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, h5py.Dataset):
            out[path] = np.asarray(v)
        else:
            _collect(v, out, path)
    return out


def load_h5_arrays(path: str) -> Dict[str, np.ndarray]:
    """Every dataset in the file, keyed by its full path."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        return _collect(root, {})


def _find(arrays: Dict[str, np.ndarray], layer: str, weight: str
          ) -> np.ndarray:
    """'<...>/<layer>/.../<weight>:0', whichever way the Keras version
    nests the layer groups."""
    suffixes = (f"{weight}:0", weight)
    for path, a in arrays.items():
        parts = path.split("/")
        if layer in parts and any(parts[-1] == s for s in suffixes):
            return a
    raise KeyError(f"h5: no weight '{weight}' for layer '{layer}' "
                   f"(have: {sorted(arrays)[:8]}...)")


def _gru(arrays, layer) -> Dict[str, np.ndarray]:
    k = _find(arrays, layer, "kernel").astype(np.float32)
    rk = _find(arrays, layer, "recurrent_kernel").astype(np.float32)
    b = _find(arrays, layer, "bias").astype(np.float32)
    if b.ndim == 1:                      # not reset_after: one bias
        b = np.stack([b, np.zeros_like(b)])
    return {"wi": k, "wr": rk, "bi": b[0], "br": b[1]}


def _dense(arrays, layer) -> Dict[str, np.ndarray]:
    return {"w": _find(arrays, layer, "kernel").astype(np.float32),
            "b": _find(arrays, layer, "bias").astype(np.float32)}


def _param_scalar(arrays, name, default):
    for path, a in arrays.items():
        if name in path.split("/")[-1]:
            return np.asarray(a).reshape(-1)[0]
    return default


def import_lpcnet_h5(path: str):
    """.h5 -> (numpy parameter tree, LPCNetConfig). The widths come from
    the file, so non-default GRU sizes import as they are."""
    from ..models.lpcnet import LPCNetConfig
    arrays = load_h5_arrays(path)
    params = {
        "embed_pitch": {
            "e": _find(arrays, "embed_pitch", "embeddings")
            .astype(np.float32)},
        "conv1": _dense(arrays, "feature_conv1"),
        "conv2": _dense(arrays, "feature_conv2"),
        "dense1": _dense(arrays, "feature_dense1"),
        "dense2": _dense(arrays, "feature_dense2"),
        "embed_sig": {
            "e": _find(arrays, "embed_sig", "embeddings")
            .astype(np.float32)},
        "gru_a": _gru(arrays, "gru_a"),
        "gru_b": _gru(arrays, "gru_b"),
        "dual_fc": {
            "w": _find(arrays, "dual_fc", "kernel")
            .astype(np.float32).transpose(2, 1, 0),
            "b": _find(arrays, "dual_fc", "bias").astype(np.float32).T,
            "factor": _find(arrays, "dual_fc", "factor")
            .astype(np.float32).T,
        },
    }
    na = params["gru_a"]["wr"].shape[0]
    nb = params["gru_b"]["wr"].shape[0]
    nc = params["dense2"]["w"].shape[1]
    es = params["embed_sig"]["e"].shape[1]
    ep = params["embed_pitch"]["e"].shape[1]
    cfg = LPCNetConfig(
        gru_a_units=na, gru_b_units=nb, cond_size=nc,
        embed_sig_size=es, embed_pitch_size=ep,
        lpc_gamma=float(_param_scalar(arrays, "lpc_gamma", 1.0)),
        e2e=bool(_param_scalar(arrays, "flag_e2e", False)),
        lookahead=int(_param_scalar(arrays, "lookahead", 2)),
    )
    got_in = params["gru_a"]["wi"].shape[0]
    if got_in != 3 * es + nc:
        raise ValueError(f"h5: gru_a input {got_in} != 3*embed_sig({es}) + "
                         f"cond({nc})")
    return params, cfg


def import_plc_h5(path: str):
    """.h5 -> (numpy parameter tree, PLCConfig)."""
    from ..models.plc import PLCConfig
    arrays = load_h5_arrays(path)
    params = {
        "dense1": _dense(arrays, "plc_dense1"),
        "gru1": _gru(arrays, "plc_gru1"),
        "gru2": _gru(arrays, "plc_gru2"),
        "out": _dense(arrays, "plc_out"),
    }
    cfg = PLCConfig(dense_size=params["dense1"]["w"].shape[1],
                    gru_size=params["gru1"]["wr"].shape[0],
                    nb_features=params["out"]["w"].shape[1])
    return params, cfg
