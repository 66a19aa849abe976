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


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the same nesting of contiguous
    float32 tensors on `device` (None means the card)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, np.float32), device=dev)

    return conv(tree)


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
