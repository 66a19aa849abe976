"""Read side of the training checkpoints (the port of
lpcnet_tpu/utils/checkpoint.py::load_training).

A training checkpoint is one DNNw blob holding the parameter tree, the
optimizer's leaves, the global step and a JSON metadata dict, described
by the record __train_manifest__; the JAX package's trainers write it
(checkpoint.save_training). The optimizer state comes back as its flat
list of leaves: its tree structure is a JAX pytree, which the port has
no use for.
"""
import json
from typing import Any, Dict, List, Tuple

import numpy as np

from . import weights_io

MANIFEST = "__train_manifest__"


def load_training(path: str) -> Tuple[Dict[str, Any], List[np.ndarray], int,
                                      Dict[str, Any]]:
    """(params as nested dicts of numpy arrays, the optimizer's leaves in
    order, the step, the metadata dict) of a training checkpoint."""
    raw = weights_io.read_blob(path)
    if MANIFEST not in raw:
        raise ValueError(f"{path}: not a training checkpoint (no {MANIFEST} "
                         "record)")
    manifest = json.loads(raw[MANIFEST].tobytes().decode())
    params = weights_io.unflatten(raw, manifest["params"])
    leaves = [raw[f"o{i:04d}"] for i in range(manifest["nopt"])]
    return params, leaves, int(manifest["step"]), manifest["meta"]
