"""Parameter trees: read from a shipped checkpoint, or drawn from a seed.

read_tree reads a "DNNw" blob with a JSON manifest (the format of the
repo's examples/*.bin: 64-byte record heads, each record padded to whole
64-byte blocks, the record "__manifest__" mapping record names to the
'/'-joined parameter path, shape and dtype) into nested dicts of numpy
arrays. to_torch puts such a tree on a device. The benchmark hands one copy
to the program and keeps another for the reference.

draw(lpcnet_spec(sizes), seed, device) draws a fresh tree from a seed on
the device in a few large calls: one uniform draw and one normal draw for
the whole tree, cut into the leaves, and one batched QR for the three
orthogonal recurrent blocks of each GRU. The shapes and the distributions
are those of the LPCNet training code (Glorot-uniform kernels, orthogonal recurrent gates, zero biases,
normal embeddings); the values are the seed's own.
"""
import json
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_BLOCK = 64
_DTYPES = {0: np.float32, 1: np.int32, 2: np.int8}


def read_tree(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays of a DNNw blob with a manifest."""
    with open(path, "rb") as f:
        data = f.read()
    raw, off = {}, 0
    while off + _BLOCK <= len(data):
        head, ver, t, size, bsize, nm = struct.unpack_from("<4siiii44s",
                                                          data, off)
        if head != b"DNNw" or ver != 0 or t not in _DTYPES or bsize < size:
            raise ValueError(f"{path}: corrupt record at offset {off}")
        dt = np.dtype(_DTYPES[t])
        raw[nm.split(b"\x00")[0].decode()] = np.frombuffer(
            data, dtype=dt, count=size // dt.itemsize, offset=off + _BLOCK)
        off += _BLOCK + bsize
    manifest = json.loads(raw.pop("__manifest__").tobytes().decode())
    tree: Dict[str, Any] = {}
    for rec, meta in manifest.items():
        node = tree
        *parents, leaf = meta["name"].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = raw[rec].astype(meta["dtype"]).reshape(meta["shape"])
    return tree


def to_torch(tree, device) -> Dict[str, Any]:
    """The same nesting as contiguous float32 tensors on `device`."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32),
                           device=device).contiguous()


def clone(tree) -> Dict[str, Any]:
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()


# leaf kinds of the spec lists below: (path, shape, kind, scale)
_Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def _glorot(nin: int, nout: int) -> float:
    return (6.0 / (nin + nout)) ** 0.5


def _dense(name, nin, nout) -> _Spec:
    return [(f"{name}/w", (nin, nout), "uniform", _glorot(nin, nout)),
            (f"{name}/b", (nout,), "zero", 0.0)]


def _gru(name, nin, n) -> _Spec:
    return [(f"{name}/wi", (nin, 3 * n), "uniform", _glorot(nin, 3 * n)),
            (f"{name}/wr", (n, 3 * n), "orthogonal", 1.0),
            (f"{name}/bi", (3 * n,), "zero", 0.0),
            (f"{name}/br", (3 * n,), "zero", 0.0)]


def _conv(name, nin, nout, k) -> _Spec:
    return [(f"{name}/w", (k, nin, nout), "uniform",
             (6.0 / (nin * k + nout)) ** 0.5),
            (f"{name}/b", (nout,), "zero", 0.0)]


def lpcnet_spec(sizes: Dict[str, int]) -> _Spec:
    """The LPCNet vocoder's parameter tree (training_tf2/lpcnet.py)."""
    na, nb, nc = sizes["gru_a_units"], sizes["gru_b_units"], sizes["cond_size"]
    es, ep = sizes["embed_sig_size"], sizes["embed_pitch_size"]
    lv, nf = sizes["pcm_levels"], sizes["nb_features"]
    return ([("embed_pitch/e", (lv, ep), "normal", 0.1)]
            + _conv("conv1", nf + ep, nc, 3) + _conv("conv2", nc, nc, 3)
            + _dense("dense1", nc, nc) + _dense("dense2", nc, nc)
            + [("embed_sig/e", (lv, es), "normal", 0.1)]
            + _gru("gru_a", 3 * es + nc, na) + _gru("gru_b", na + nc, nb)
            + [("dual_fc/w", (2, nb, lv), "uniform", _glorot(nb, lv)),
               ("dual_fc/b", (2, lv), "zero", 0.0),
               ("dual_fc/factor", (2, lv), "factor", 0.01)])


def plc_spec(sizes: Dict[str, int]) -> _Spec:
    """The PLC network's parameter tree (training_tf2/lpcnet_plc.py): 57
    inputs, a dense layer, two GRUs, the 20 predicted features."""
    d, g, nf = sizes["dense_size"], sizes["gru_size"], sizes["nb_features"]
    return (_dense("dense1", 2 * 18 + nf + 1, d) + _gru("gru1", d, g)
            + _gru("gru2", g, g) + _dense("out", g, nf))


def draw(spec: _Spec, seed: int, device) -> Dict[str, Any]:
    """A tree of the spec's leaves drawn from `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_uni = sum(int(np.prod(s)) for _, s, k, _ in spec if k == "uniform")
    n_nrm = sum(int(np.prod(s)) for _, s, k, _ in spec
                if k in ("normal", "factor"))
    uni = torch.rand(n_uni, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    tree: Dict[str, Any] = {}
    iu = inr = 0
    for path, shape, kind, scale in spec:
        size = int(np.prod(shape))
        if kind == "uniform":
            leaf = uni[iu:iu + size].reshape(shape) * scale
            iu += size
        elif kind in ("normal", "factor"):
            leaf = nrm[inr:inr + size].reshape(shape) * scale
            inr += size
            if kind == "factor":
                leaf = leaf + 1.0
        elif kind == "orthogonal":
            n = shape[0]
            q, r = torch.linalg.qr(torch.randn((3, n, n), generator=gen,
                                               device=device))
            q = q * torch.sign(torch.diagonal(r, dim1=-2,
                                              dim2=-1))[..., None, :]
            leaf = q.permute(1, 0, 2).reshape(shape)
        else:
            leaf = torch.zeros(shape, device=device)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf.contiguous()
    return tree
