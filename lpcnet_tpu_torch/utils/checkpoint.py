"""Training checkpoints (the port of lpcnet_tpu/utils/checkpoint.py).

A training checkpoint is one DNNw blob holding the parameter tree, the
optimizer's leaves, the global step and a JSON metadata dict, described
by the record __train_manifest__. Both packages' trainers write and read
the same blob: the parameters as records p0000, p0001, ... in the sorted
order of their '/'-joined paths, the optimizer's leaves as o0000, ... in
optax's leaf order (training/optim.py::state_leaves). The optimizer state
comes back as its flat list of leaves (optim.state_from_leaves rebuilds
the port's).
"""
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import weights_io

MANIFEST = "__train_manifest__"


def save_training(path: str, params: Dict[str, Any],
                  opt_leaves: Sequence[np.ndarray], step: int,
                  meta: Optional[Dict[str, Any]] = None) -> None:
    """Write params (nested dicts of numpy arrays, convert.params_to_numpy
    of the port's), the optimizer's leaves, the step and meta as one blob,
    record for record as lpcnet_tpu's save_training writes it."""
    arrays: Dict[str, np.ndarray] = {}
    flat = weights_io.flatten(params)
    manifest = {"params": {}, "nopt": 0, "step": int(step),
                "meta": meta or {}}
    for i, (name, a) in enumerate(sorted(flat.items())):
        rec = f"p{i:04d}"
        arrays[rec] = a.astype(np.float32) if a.dtype == np.float64 else a
        manifest["params"][rec] = {"name": name, "shape": list(a.shape),
                                   "dtype": str(arrays[rec].dtype)}
    manifest["nopt"] = len(opt_leaves)
    for i, leaf in enumerate(opt_leaves):
        arrays[f"o{i:04d}"] = np.asarray(leaf)
    arrays[MANIFEST] = np.frombuffer(json.dumps(manifest).encode(),
                                     np.int8).copy()
    weights_io.write_blob(path, arrays)


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
