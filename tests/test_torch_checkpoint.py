"""The port's checkpoint loading (convert.load_model_params, utils/
checkpoint.py) against the JAX package's on blobs that the JAX package
wrote: a training checkpoint of checkpoint.save_training and a plain
save_params blob. Loading is exact: the same arrays, bit for bit."""
import os

import jax
import numpy as np
import pytest
import torch

from lpcnet_tpu import cli as j_cli
from lpcnet_tpu.utils import checkpoint as j_ckpt
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.utils import checkpoint as t_ckpt

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
MODELS = {"lpcnet": ("speech_lpcnet_params.bin", convert.load_lpcnet),
          "plc": ("speech_plc_params.bin", convert.load_plc)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _never(_):
    raise AssertionError("a checkpoint path must not fall back to init")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_training_checkpoint_loads_as_jax_loads_it(model, tmp_path):
    """A blob of JAX checkpoint.save_training with the shipped parameters,
    three optimizer leaves of three dtypes, a step and a metadata dict: the
    port's loader gives the parameters JAX cli.load_model_params gives,
    exactly, and load_training the leaves, step and metadata."""
    name, load = MODELS[model]
    params = j_wio.load_params(os.path.join(EXAMPLES, name))
    rs = np.random.RandomState(1)
    leaves = [rs.randn(3, 5).astype(np.float32),
              np.arange(7, dtype=np.int32),
              rs.randint(-128, 128, 11).astype(np.int8)]
    meta = {"epoch": 3, "lr": 0.001, "name": model}
    path = str(tmp_path / "train.bin")
    j_ckpt.save_training(path, params, leaves, step=1234, meta=meta)

    want = j_cli.load_model_params(path, _never)
    _assert_same_tree(convert.load_model_params(path), want)
    _assert_same_tree(load(path, device="cpu"),
                      jax.tree.map(np.asarray, want))
    got_params, got_leaves, step, got_meta = t_ckpt.load_training(path)
    _assert_same_tree(got_params, want)
    assert step == 1234 and got_meta == meta
    assert len(got_leaves) == len(leaves)
    for g, w in zip(got_leaves, leaves):
        np.testing.assert_array_equal(g, w.reshape(-1))
        assert g.dtype == w.dtype


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plain_params_blob_still_loads(model, tmp_path):
    """A save_params blob (no training manifest) loads through the same
    entry as before, exactly; load_training refuses it."""
    name, load = MODELS[model]
    params = j_wio.load_params(os.path.join(EXAMPLES, name))
    path = str(tmp_path / "params.bin")
    j_wio.save_params(path, params)
    _assert_same_tree(load(path, device="cpu"), params)
    _assert_same_tree(convert.load_model_params(path),
                      j_cli.load_model_params(path, _never))
    with pytest.raises(ValueError, match="training checkpoint"):
        t_ckpt.load_training(path)
