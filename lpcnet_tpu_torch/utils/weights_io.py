"""Read side of the "DNNw" weight blob format, in pure numpy (the port of
lpcnet_tpu/utils/weights_io.py without its native ctypes path).

Record layout: nnet.h:41-61 WeightHead; parser parse_lpcnet_weights.c:36-77.
load_params reads the checkpoints that lpcnet_tpu's save_params writes
('/'-joined parameter paths and shapes in a JSON manifest record), and the
training checkpoints of lpcnet_tpu's save_training through
utils/checkpoint.py.
"""
import json
import struct
from typing import Any, Dict

import numpy as np

BLOCK = 64
TYPE_FLOAT, TYPE_INT, TYPE_QWEIGHT = 0, 1, 2
_DTYPES = {TYPE_FLOAT: np.float32, TYPE_INT: np.int32, TYPE_QWEIGHT: np.int8}


def read_blob(path: str) -> Dict[str, np.ndarray]:
    """Read all DNNw records -> {name: flat array} (validated)."""
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + BLOCK <= len(data):
        head, ver, t, size, bsize, nm = struct.unpack_from(
            "<4siiii44s", data, off)
        if head != b"DNNw" or ver != 0 or size < 0 or bsize < size \
                or bsize > len(data) - off - BLOCK or t not in _DTYPES:
            raise ValueError(f"corrupt record at offset {off}")
        name = nm.split(b"\x00")[0].decode()
        dt = _DTYPES[t]
        out[name] = np.frombuffer(
            data, dtype=dt, count=size // np.dtype(dt).itemsize,
            offset=off + BLOCK).copy()
        off += BLOCK + bsize
    return out


def unflatten(raw: Dict[str, np.ndarray],
              records: Dict[str, Any]) -> Dict[str, Any]:
    """The nested dict of numpy arrays that a manifest's records describe:
    {record: {"name": '/'-joined path, "shape", "dtype"}}."""
    out: Dict[str, Any] = {}
    for rec, meta in records.items():
        a = raw[rec].astype(meta["dtype"]).reshape(meta["shape"])
        node = out
        parts = meta["name"].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return out


def load_params(path: str) -> Dict[str, Any]:
    """Load a checkpoint written by save_params back into a nested dict of
    numpy arrays."""
    raw = read_blob(path)
    return unflatten(raw, json.loads(raw.pop("__manifest__").tobytes()
                                     .decode()))
