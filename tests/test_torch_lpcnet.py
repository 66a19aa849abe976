"""The port's conditioning half of the vocoder (models/layers.py,
models/lpcnet.py) against the JAX package at full width with the shipped
weights."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import layers as j_layers
from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.models import layers as t_layers
from lpcnet_tpu_torch.models import lpcnet as t_lpcnet

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
FEATS = np.fromfile(os.path.join(os.path.dirname(__file__), "golden",
                                 "ref_feats.f32"), np.float32).reshape(-1, 36)


@pytest.fixture(scope="module")
def models():
    tree = j_wio.load_params(os.path.join(REPO, "examples",
                                          "speech_lpcnet_params.bin"))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, "cpu")
    return jp, tp


def test_config_matches():
    assert (dataclasses.asdict(t_lpcnet.LPCNetConfig())
            == dataclasses.asdict(j_lpcnet.LPCNetConfig()))


def test_pitch_index_exact():
    f = FEATS[None, :, :]
    np.testing.assert_array_equal(
        t_lpcnet.pitch_index(torch.as_tensor(f)).numpy(),
        np.asarray(j_lpcnet.pitch_index(jnp.asarray(f))))


def test_conv1d_same_close(models):
    # 1e-5: three shifted float32 matmuls vs XLA's convolution
    jp, tp = models
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, 84).astype(np.float32)
    got = t_layers.conv1d_same_apply(tp["conv1"], torch.as_tensor(x))
    want = j_layers.conv1d_same_apply(jp["conv1"], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sample_tables_close(models):
    # 1e-5: (256,128)x(128,1152) products summed in another order
    jp, tp = models
    jt = j_lpcnet.precompute_sample_tables(jp, j_lpcnet.LPCNetConfig())
    tt = t_lpcnet.precompute_sample_tables(tp, t_lpcnet.LPCNetConfig())
    for k in ("tbl_sig", "tbl_pred", "tbl_exc", "cond_a_w", "wr_a", "wi_b",
              "cond_b_w", "wr_b", "br_a", "br_b", "bi_a", "bi_b"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_frame_conditions_close(models):
    """cond_a, cond_b, lpc at B=2, T=8 from the reference features; rtol and
    atol 1e-4 (float32 sums of a few hundred terms in another order, an
    inverse FFT and a 16-step Levinson recursion)."""
    jp, tp = models
    f = np.stack([FEATS[10:18], FEATS[120:128]])
    cfg_j, cfg_t = j_lpcnet.LPCNetConfig(), t_lpcnet.LPCNetConfig()
    want = j_lpcnet.frame_conditions(jp, jnp.asarray(f), cfg_j)
    got = t_lpcnet.frame_conditions(tp, torch.as_tensor(f), cfg_t)
    for k in ("cond_a", "cond_b", "lpc", "cfeat"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_rc2lpc_close():
    # 1e-6: the same step-up recursion, float32
    rc = np.random.RandomState(4).uniform(-0.9, 0.9, (3, 16)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        t_lpcnet.rc2lpc(torch.as_tensor(rc)).numpy(),
        np.asarray(j_lpcnet.rc2lpc(jnp.asarray(rc))), rtol=1e-6, atol=1e-6)
