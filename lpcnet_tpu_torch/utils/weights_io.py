"""The "DNNw" weight blob format, in pure numpy (the port of
lpcnet_tpu/utils/weights_io.py without its native ctypes path).

Record layout: nnet.h:41-61 WeightHead; writer write_lpcnet_weights.c:
47-67; parser parse_lpcnet_weights.c:36-77. save_params / load_params
write and read parameter trees ('/'-joined parameter paths and shapes in a
JSON manifest record), as lpcnet_tpu's do; the training checkpoints of
lpcnet_tpu's save_training are read through utils/checkpoint.py.
sparse_to_dense expands the reference's 8x4 block-sparse export format
(dump_lpcnet.py:85-121).
"""
import json
import struct
from typing import Any, Dict

import numpy as np

BLOCK = 64
TYPE_FLOAT, TYPE_INT, TYPE_QWEIGHT = 0, 1, 2
_DTYPES = {TYPE_FLOAT: np.float32, TYPE_INT: np.int32, TYPE_QWEIGHT: np.int8}
_TYPE_OF = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_blob(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write named float32, int32 or int8 arrays as DNNw records (names
    truncated to 43 bytes), each padded to whole 64-byte blocks."""
    with open(path, "wb") as f:
        for name, a in arrays.items():
            a = np.ascontiguousarray(a)
            if a.dtype not in _TYPE_OF:
                raise ValueError(f"{name}: a DNNw record holds float32, "
                                 f"int32 or int8, not {a.dtype}")
            size = a.nbytes
            bsize = (size + BLOCK - 1) // BLOCK * BLOCK
            f.write(struct.pack("<4siiii44s", b"DNNw", 0, _TYPE_OF[a.dtype],
                                size, bsize, name.encode()[:43]))
            f.write(a.tobytes())
            f.write(b"\x00" * (bsize - size))


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


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {'/'-joined path: numpy array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def save_params(path: str, params: Dict[str, Any]) -> None:
    """A parameter tree as a DNNw blob: records a0000, a0001, ... in the
    sorted order of the paths (float64 stored as float32), and a JSON
    manifest of names, shapes and dtypes in the record __manifest__."""
    arrays, manifest = {}, {}
    for i, (name, a) in enumerate(sorted(flatten(params).items())):
        rec = f"a{i:04d}"   # record names are limited to 43 bytes
        arrays[rec] = a.astype(np.float32) if a.dtype == np.float64 else a
        manifest[rec] = {"name": name, "shape": list(a.shape),
                         "dtype": str(arrays[rec].dtype)}
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(),
                                           dtype=np.int8).copy()
    write_blob(path, arrays)


def load_params(path: str) -> Dict[str, Any]:
    """Load a checkpoint written by save_params back into a nested dict of
    numpy arrays."""
    raw = read_blob(path)
    return unflatten(raw, json.loads(raw.pop("__manifest__").tobytes()
                                     .decode()))


def sparse_to_dense(idx: np.ndarray, weights: np.ndarray, rows: int,
                    cols: int, block_rows: int = 8,
                    block_cols: int = 4) -> np.ndarray:
    """Expand the reference's block-sparse layout to a dense (rows, cols)
    matrix (layout: sparse_sgemv_accum8x4, vec.h:306-339; exporter
    dump_lpcnet.py:85-121). idx: per 8-row band [nblocks, col0, col1, ...];
    weights: concatenated 8x4 blocks in band order, row-major within a
    block (the kernel reads w[r*4 + c])."""
    dense = np.zeros((rows, cols), dtype=np.float32)
    nblk = block_rows * block_cols
    wpos, p = 0, 0
    for r0 in range(0, rows, block_rows):
        nb = int(idx[p])
        p += 1
        for _ in range(nb):
            c0 = int(idx[p])
            p += 1
            blk = np.asarray(weights[wpos:wpos + nblk], np.float32)
            wpos += nblk
            dense[r0:r0 + block_rows, c0:c0 + block_cols] = blk.reshape(
                block_rows, block_cols)
    return dense
