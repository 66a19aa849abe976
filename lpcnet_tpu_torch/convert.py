"""Weights carried across from the JAX package.

The JAX package's parameters are a pytree of nested dicts; as numpy arrays
(lpcnet_tpu's load_params, or jax.tree.map(np.asarray, params)) they become
the port's parameters here: the same nesting, float32 tensors on a device.
"""
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .utils import checkpoint, weights_io

_EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
DEFAULT_LPCNET = os.path.join(_EXAMPLES, "speech_lpcnet_params.bin")
DEFAULT_PLC = os.path.join(_EXAMPLES, "speech_plc_params.bin")
DEFAULT_DRED = os.path.join(_EXAMPLES, "speech_dred_params.bin")


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the same nesting of contiguous
    float32 tensors on `device` (None means the card)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, np.float32), device=dev)

    return conv(tree)


def to_device(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The same nesting of tensors as contiguous float32 on `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32).contiguous()


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of params_from_numpy: tensors -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def load_model_params(path: str) -> Dict[str, Any]:
    """The numpy parameter tree of a save_params checkpoint or of a
    training checkpoint (the dispatch of lpcnet_tpu/cli.py::
    load_model_params)."""
    if checkpoint.MANIFEST in weights_io.read_blob(path):
        return checkpoint.load_training(path)[0]
    return weights_io.load_params(path)


def load_lpcnet(path: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Vocoder parameters from a save_params or training checkpoint; path
    None loads the shipped examples/speech_lpcnet_params.bin."""
    return params_from_numpy(load_model_params(path or DEFAULT_LPCNET),
                             device)


def load_plc(path: Optional[str] = None, device=None) -> Dict[str, Any]:
    """PLC-network parameters from a save_params or training checkpoint;
    path None loads the shipped examples/speech_plc_params.bin."""
    return params_from_numpy(load_model_params(path or DEFAULT_PLC), device)


def load_lpcnet_model(path: Optional[str] = None, default_cfg=None,
                      device=None):
    """Vocoder parameters and config (the dispatch of lpcnet_tpu/cli.py::
    load_lpcnet_model): a .h5 file is a reference Keras checkpoint, whose
    widths, lpc_gamma, lookahead and flag_e2e make the config
    (utils/import_keras.py); anything else is read by load_lpcnet and
    takes default_cfg (None: LPCNetConfig()). Returns (params on
    `device`, LPCNetConfig)."""
    from .models import lpcnet
    if path and path.endswith(".h5"):
        from .utils import import_keras
        tree, cfg = import_keras.import_lpcnet_h5(path)
        return params_from_numpy(tree, device), cfg
    return load_lpcnet(path, device), default_cfg or lpcnet.LPCNetConfig()


def load_plc_model(path: Optional[str] = None, device=None):
    """PLC-network parameters and config: a .h5 file through
    utils/import_keras.py (as lpcnet_tpu/cli.py's plc command reads one),
    anything else through load_plc with PLCConfig(). Returns (params on
    `device`, PLCConfig)."""
    from .models import plc
    if path and path.endswith(".h5"):
        from .utils import import_keras
        tree, cfg = import_keras.import_plc_h5(path)
        return params_from_numpy(tree, device), cfg
    return load_plc(path, device), plc.PLCConfig()


def load_dred(path: Optional[str] = None, device=None):
    """RDO-VAE parameters and config (the port of lpcnet_tpu/cli.py::
    load_dred_model); path None loads the shipped
    examples/speech_dred_params.bin. A .pth/.pt file is a reference torch
    trainer checkpoint and a directory a wexchange numpy export, both read
    by utils/import_torch.py; anything else is a save_params or training
    checkpoint, whose cond geometry is read from its kernel shapes.
    Returns (params on `device`, RDOVAEConfig)."""
    from .models import rdovae as rv
    from .utils import import_torch
    path = path or DEFAULT_DRED
    if path.endswith((".pth", ".pt")):
        tree, cfg = import_torch.import_rdovae_torch(path)
    elif os.path.isdir(path):
        tree, cfg = import_torch.import_rdovae_numpy_dir(path)
    else:
        tree = load_model_params(path)
        enc = tree["enc"]
        cfg = rv.RDOVAEConfig(cond_size=int(np.shape(enc["gru2"]["wr"])[0]),
                              cond_size2=int(np.shape(enc["dense1"]["w"])[1]))
    return params_from_numpy(tree, device), cfg
