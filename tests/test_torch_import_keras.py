"""The port's Keras .h5 import (lpcnet_tpu_torch/utils/import_keras.py,
convert.load_lpcnet_model / load_plc_model) against the JAX package's
(lpcnet_tpu/utils/import_keras.py) on the .h5 files of
tests/test_import_keras.py: parameter trees array_equal, configs equal;
the port's synthesis, plc and train-lpcnet --retrain commands read a .h5.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from lpcnet_tpu.utils import import_keras as j_ik  # noqa: E402
from lpcnet_tpu_torch import cli as t_cli  # noqa: E402
from lpcnet_tpu_torch import convert  # noqa: E402
from lpcnet_tpu_torch.models import lpcnet as t_lm  # noqa: E402
from lpcnet_tpu_torch.models import plc as t_plc  # noqa: E402
from lpcnet_tpu_torch.plc import PLCEngine, PLCOptions  # noqa: E402
from lpcnet_tpu_torch.utils import checkpoint as t_ck  # noqa: E402
from lpcnet_tpu_torch.utils import import_keras as t_ik  # noqa: E402
from lpcnet_tpu_torch.vocoder import Synthesizer  # noqa: E402
from test_import_keras import make_lpcnet_h5, make_plc_h5  # noqa: E402

HERE = os.path.dirname(__file__)
FEATS = np.fromfile(os.path.join(HERE, "golden", "ref_feats.f32"),
                    np.float32).reshape(-1, 36)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's commands: with several test
    workers on one host, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def _same_config(j_cfg, t_cfg):
    """Every field of the JAX config equals the port's field."""
    for f in dataclasses.fields(j_cfg):
        assert getattr(t_cfg, f.name) == getattr(j_cfg, f.name), f.name


@pytest.mark.parametrize("seed", [0, 5])
def test_lpcnet_h5_tree_and_config_equal_jax(tmp_path, seed):
    p = str(tmp_path / "m.h5")
    make_lpcnet_h5(p, seed=seed)
    j_params, j_cfg = j_ik.import_lpcnet_h5(p)
    t_params, t_cfg = t_ik.import_lpcnet_h5(p)
    _assert_trees_equal(j_params, t_params)
    _same_config(j_cfg, t_cfg)
    assert t_cfg.gru_a_units == 96 and t_cfg.lpc_gamma == np.float32(0.9)


def test_lpcnet_h5_one_bias_gru_and_missing_layer(tmp_path):
    """A GRU with one bias (not reset_after) gets a zero recurrent bias in
    both packages; a missing layer raises a KeyError that names it."""
    p = str(tmp_path / "m.h5")
    make_lpcnet_h5(p)
    with h5py.File(p, "r+") as f:
        b = np.asarray(f["model_weights/gru_b/gru_b/bias:0"])[0]
        del f["model_weights/gru_b/gru_b/bias:0"]
        f["model_weights/gru_b/gru_b"].create_dataset("bias:0", data=b)
    _assert_trees_equal(j_ik.import_lpcnet_h5(p)[0],
                        t_ik.import_lpcnet_h5(p)[0])
    with h5py.File(p, "r+") as f:
        del f["model_weights/gru_a"]
    with pytest.raises(KeyError, match="gru_a"):
        t_ik.import_lpcnet_h5(p)


def test_plc_h5_tree_and_config_equal_jax(tmp_path):
    p = str(tmp_path / "plc.h5")
    make_plc_h5(p)
    j_params, j_cfg = j_ik.import_plc_h5(p)
    t_params, t_cfg = t_ik.import_plc_h5(p)
    _assert_trees_equal(j_params, t_params)
    _same_config(j_cfg, t_cfg)
    params, cfg = convert.load_plc_model(p, device="cpu")
    assert cfg == t_cfg and torch.equal(
        params["gru1"]["wr"], torch.as_tensor(j_params["gru1"]["wr"]))


def test_missing_h5py_is_named(tmp_path, monkeypatch):
    """Where h5py is not installed, reading a .h5 raises an ImportError
    that names it (the card's machine has no h5py)."""
    p = str(tmp_path / "m.h5")
    make_lpcnet_h5(p)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        convert.load_lpcnet_model(p, device="cpu")


def test_load_lpcnet_model_dispatch(tmp_path):
    """A .h5 brings its own config; any other path takes default_cfg."""
    p = str(tmp_path / "m.h5")
    make_lpcnet_h5(p)
    params, cfg = convert.load_lpcnet_model(p, device="cpu")
    assert cfg == t_ik.import_lpcnet_h5(p)[1]
    assert params["gru_a"]["wr"].shape == (96, 288)
    default = t_lm.LPCNetConfig(lookahead=0)
    params, cfg = convert.load_lpcnet_model(None, default, device="cpu")
    assert cfg is default and params["gru_a"]["wr"].shape == (384, 1152)


def test_synthesis_cli_reads_h5(tmp_path):
    """synthesis --device cpu --weights x.h5 writes the pcm of a
    Synthesizer built from the JAX-imported tree and config."""
    p = str(tmp_path / "m.h5")
    make_lpcnet_h5(p)
    feats = FEATS[:6]
    feats.tofile(tmp_path / "f.f32")
    out = str(tmp_path / "out.pcm")
    assert t_cli.main(["synthesis", str(tmp_path / "f.f32"), out,
                       "--weights", p, "--device", "cpu"]) == 0
    j_params, j_cfg = j_ik.import_lpcnet_h5(p)
    cfg = t_lm.LPCNetConfig(**dataclasses.asdict(j_cfg))
    voc = Synthesizer(cfg, params=convert.params_from_numpy(j_params, "cpu"),
                      device="cpu")
    _, pcm = voc.synthesize(voc.reset(1), feats[None])
    t_cli.write_pcm(str(tmp_path / "ref.pcm"), pcm[0].numpy())
    got = np.fromfile(out, np.int16)
    assert got.size == 6 * 160
    np.testing.assert_array_equal(got, np.fromfile(tmp_path / "ref.pcm",
                                                   np.int16))


def test_plc_cli_reads_h5(tmp_path):
    """plc --weights x.h5 --plc-weights y.h5 conceals with an engine built
    from the JAX-imported trees and configs."""
    lp, pp = str(tmp_path / "m.h5"), str(tmp_path / "plc.h5")
    make_lpcnet_h5(lp)
    make_plc_h5(pp)
    x = np.fromfile(os.path.join(HERE, "golden", "speech.s16"), np.int16)
    x[:4 * 160].tofile(tmp_path / "in.pcm")
    (tmp_path / "loss.txt").write_text("0\n1\n")
    out = str(tmp_path / "out.pcm")
    assert t_cli.main(["plc", str(tmp_path / "loss.txt"),
                       str(tmp_path / "in.pcm"), out, "--weights", lp,
                       "--plc-weights", pp, "--device", "cpu"]) == 0
    j_lp, j_cfg = j_ik.import_lpcnet_h5(lp)
    j_pp, j_pcfg = j_ik.import_plc_h5(pp)
    eng = PLCEngine(convert.params_from_numpy(j_lp, "cpu"),
                    convert.params_from_numpy(j_pp, "cpu"),
                    t_lm.LPCNetConfig(**dataclasses.asdict(j_cfg)),
                    t_plc.PLCConfig(**dataclasses.asdict(j_pcfg)),
                    options=PLCOptions(), device="cpu")
    state = eng.init_state(1)
    pcm = x[:4 * 160].astype(np.float32)
    ref = []
    for f, lost in enumerate([0, 0, 1, 1]):
        state, o = eng.step(state, pcm[None, f * 160:(f + 1) * 160],
                            [bool(lost)])
        ref.append(o[0].numpy())
    t_cli.write_pcm(str(tmp_path / "ref.pcm"), np.concatenate(ref))
    np.testing.assert_array_equal(np.fromfile(out, np.int16),
                                  np.fromfile(tmp_path / "ref.pcm",
                                              np.int16))


def test_train_lpcnet_retrains_from_h5(tmp_path):
    """train-lpcnet --retrain x.h5 starts from the file's parameters at its
    widths: one step at GRU-A 96 writes a checkpoint of those shapes.
    make_lpcnet_h5's N(0, 1) weights are scaled by 0.05 first: at full
    scale the loss's gradients are NaN in both packages."""
    p = str(tmp_path / "m.h5")
    make_lpcnet_h5(p)
    with h5py.File(p, "r+") as f:
        def scale(name, obj):
            if isinstance(obj, h5py.Dataset) and "parameters" not in name:
                obj[...] = np.asarray(obj) * 0.05
        f.visititems(scale)
    feats, data = tmp_path / "f.f32", tmp_path / "d.s16"
    rs = np.random.RandomState(0)
    f = rs.randn(40, 36).astype(np.float32) * 0.3
    f[:, 20:] = 0.0
    f.tofile(feats)
    (rs.randn(40 * 160, 2) * 500).astype(np.int16).tofile(data)
    out = str(tmp_path / "run")
    assert t_cli.main(["train-lpcnet", str(feats), str(data), out,
                       "--batch-size", "1", "--steps-per-epoch", "1",
                       "--epochs", "1", "--device", "cpu",
                       "--retrain", p]) == 0
    tree = t_ck.load_training(os.path.join(out, "ckpt_000.bin"))[0]
    j_params, _ = j_ik.import_lpcnet_h5(p)
    assert tree["gru_a"]["wr"].shape == j_params["gru_a"]["wr"].shape
    # one Adam step of lr 1e-3 moves each entry by at most ~1e-3 (dense1
    # is not weight-clipped)
    assert all(np.isfinite(a).all() for a in (tree["dense1"]["w"],
                                              tree["gru_a"]["wr"]))
    assert np.abs(tree["dense1"]["w"] - j_params["dense1"]["w"]).max() < 2e-3
