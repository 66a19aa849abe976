"""The port's RDO-VAE and PLC training and codebook training
(models/rdovae.py's training pieces, training/rdovae_task.py,
training/plc_task.py, codec/vq_train.py, the train-rdovae, train-plc and
vq-train commands) against the JAX package's on the same seeded inputs,
with JAX's random draws passed in.

First the two gradient repairs of models/rdovae.py: pvq_quantize's
straight-through gradient (its q - xn is detached, as JAX's
stop_gradient) and _softplus's gradient sigmoid(x), also at x = 0, where
the quant embedding starts. Both are checked against jax.grad on inputs
with exact zeros.

Gates: the loss relative 1e-5 and every gradient leaf max |d| <= 1e-4 *
max |g_jax|, as for LPCNet (tests/test_torch_train_lpcnet.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.codec import vq_train as j_vq
from lpcnet_tpu.models import plc as j_plc
from lpcnet_tpu.models import rdovae as j_rv
from lpcnet_tpu.training import plc_task as j_plct
from lpcnet_tpu.training import rdovae_task as j_rvt
from lpcnet_tpu_torch import cli as t_cli
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.codec import vq_train as t_vq
from lpcnet_tpu_torch.models import plc as t_plc
from lpcnet_tpu_torch.models import rdovae as t_rv
from lpcnet_tpu_torch.training import optim
from lpcnet_tpu_torch.training import plc_task as t_plct
from lpcnet_tpu_torch.training import rdovae_task as t_rvt
from lpcnet_tpu_torch.utils import checkpoint as t_ck

HERE = os.path.dirname(__file__)
FEATS = np.fromfile(os.path.join(HERE, "golden", "ref_feats.f32"),
                    np.float32).reshape(-1, 36)
SMALL = dict(cond_size=32, cond_size2=32)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's recurrences are step loops of thousands of small ops;
    with several test workers on one host, intra-op threads only contend
    (a full-width step took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_grads(g_t, g_j, what):
    worst = 0.0
    for (path, gj), gt in zip(jax.tree_util.tree_flatten_with_path(g_j)[0],
                              optim.tree_leaves(g_t)):
        gj = np.asarray(gj)
        d, m = float(np.abs(gt.numpy() - gj).max()), float(np.abs(gj).max())
        worst = max(worst, d / m if m else d)
        assert d <= GRAD_REL * m, (jax.tree_util.keystr(path), d, m)
    print(f"\n{what}: worst gradient leaf max|d| / max|g| = {worst:.3e}")


# ---------------------------------------------------------------- repairs

def test_softplus_gradient_is_sigmoid_at_zero():
    """jax.nn.softplus sends sigmoid(x) back, 0.5 at x = 0; the port's
    logaddexp form differentiated term by term sent 1."""
    x = np.array([0.0, -0.0, 0.0, 1.5, -2.0, 30.0, -30.0], np.float32)
    w = np.arange(1, 8, dtype=np.float32)
    gj = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.softplus(v) * w))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    vt = torch.sum(t_rv._softplus(xt) * torch.as_tensor(w))
    (gt,) = torch.autograd.grad(vt, xt)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        t_rv._softplus(torch.as_tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape,k", [((4, 24), 82), ((2, 24), 82),
                                     ((3, 5, 24), 10)])
def test_pvq_quantize_has_the_straight_through_gradient(shape, k):
    """The port's PVQ value equals JAX's and its gradient is jax.grad's of
    xn + stop_gradient(q - xn): that of the normalised input (the parent
    sent 0 back)."""
    rs = np.random.RandomState(sum(shape) + k)
    x = rs.randn(*shape).astype(np.float32)
    x[..., :3] = 0.0                                    # exact zeros
    ct = rs.randn(*shape).astype(np.float32)
    vj, gj = jax.value_and_grad(
        lambda v: jnp.sum(j_rv.pvq_quantize(v, k) * ct))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    q = t_rv.pvq_quantize(xt, k)
    (gt,) = torch.autograd.grad(torch.sum(q * torch.as_tensor(ct)), xt)
    np.testing.assert_array_equal(
        q.detach().numpy(),
        np.asarray(j_rv.pvq_quantize(jnp.asarray(x), k)))
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0.1
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=1e-6 * np.abs(gj).max())


def test_rate_losses_match_jax_at_zero_symbols():
    """feat_dist_loss and the rate losses with symbols exactly 0 (JAX's
    abs sends 1 back there, torch.abs 0) and zero-initialised entropy
    parameters."""
    rs = np.random.RandomState(12)
    z = rs.randn(2, 6, 80).astype(np.float32) * 2
    z[:, :2] = 0.0
    e = rs.randn(2, 6, 320).astype(np.float32)
    e[:, :, :40] = 0.0
    lam = (2e-4 * np.exp(rs.randint(0, 16, (2, 6, 1)) / 3.8)).astype(
        np.float32)
    yt = rs.randn(2, 12, 20).astype(np.float32) * 0.5
    yp = yt.copy()
    yp[:, :6] += rs.randn(2, 6, 20).astype(np.float32) * 0.1

    def total(m, z, e, yp):
        jx = m is j_rv
        sig = jax.nn.sigmoid if jx else torch.sigmoid
        lam_m = jnp.asarray(lam) if jx else torch.as_tensor(lam)
        yt_m = jnp.asarray(yt) if jx else torch.as_tensor(yt)
        lam_up = jnp.repeat(lam_m, 2, axis=1) if jx \
            else lam_m.repeat_interleave(2, dim=1)
        soft, hard = sig(e[..., :160]), sig(e[..., 160:])
        return (m.sq1_rate_loss(z, soft, lam_m)
                + m.sq2_rate_loss(z, hard, lam_m)
                + m.feat_dist_loss(yt_m, yp, lam_up)
                + m.sq_rate_metric(z, hard))

    vj, gj = jax.value_and_grad(lambda *a: total(j_rv, *a),
                                argnums=(0, 1, 2))(
        jnp.asarray(z), jnp.asarray(e), jnp.asarray(yp))
    ts = [torch.tensor(a, requires_grad=True) for a in (z, e, yp)]
    vt = total(t_rv, *ts)
    gt = torch.autograd.grad(vt, ts)
    np.testing.assert_allclose(float(vt.detach()), float(vj),
                               rtol=LOSS_RTOL)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= GRAD_REL * np.abs(b).max()


# ------------------------------------------------------------- rdovae_task

@pytest.fixture(scope="module")
def rdovae_params():
    """JAX's init at cond 32/32 with its rate-aware quant init (so the
    dead-zone inputs stay at exactly 0), as numpy."""
    cfg = j_rv.RDOVAEConfig(**SMALL)
    return _np(j_rv.rate_aware_quant_init(
        j_rv.init_params(jax.random.PRNGKey(3), cfg), cfg))


def test_rdovae_loss_and_grads_match_jax(rdovae_params):
    """loss_fn with JAX's draws injected (quant levels, uniform noise):
    the loss within LOSS_RTOL, every gradient leaf within GRAD_REL."""
    cfg_j, cfg_t = j_rv.RDOVAEConfig(**SMALL), t_rv.RDOVAEConfig(**SMALL)
    B, T = 2, 16
    feats = FEATS[:B * T, :20].reshape(B, T, 20).copy()
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    qid, lam = j_rvt.sample_lambda(k1, B, T // 2)
    noise = np.asarray(jax.random.uniform(k2, (B, T // 2, 80), minval=-0.5,
                                          maxval=0.5))
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: j_rvt.loss_fn(p, jnp.asarray(feats), qid, lam, k2, cfg_j),
        has_aux=True))(jax.tree.map(jnp.asarray, rdovae_params))
    qt, lt_ = t_rvt.sample_lambda(torch.as_tensor(np.asarray(qid)[:, :1]),
                                  B, T // 2)
    np.testing.assert_allclose(lt_.numpy(), np.asarray(lam), rtol=1e-6)
    (lt, mt), gt = optim.value_and_grad(
        lambda p: t_rvt.loss_fn(p, torch.as_tensor(feats), qt, lt_,
                                torch.as_tensor(noise), cfg_t),
        convert.params_from_numpy(rdovae_params, "cpu"))
    print(f"\nrdovae loss: port {float(lt):.8f} jax {float(lj):.8f}")
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4)
    _assert_grads(gt, gj, "rdovae")


def test_rdovae_weight_clip_and_init_match_jax(rdovae_params):
    p = jax.tree.map(lambda a: a * 4.0, rdovae_params)
    wj = _np(j_rvt.weight_clip(jax.tree.map(jnp.asarray, p)))
    wt = t_rvt.weight_clip(convert.params_from_numpy(p, "cpu"))
    for a, b in zip(optim.tree_leaves(wt), jax.tree.leaves(wj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-7)
    cfg_t = t_rv.RDOVAEConfig(**SMALL)
    it = t_rv.rate_aware_quant_init(
        t_rv.init_params(torch.Generator().manual_seed(0), cfg_t), cfg_t)
    assert jax.tree.structure(rdovae_params) == jax.tree.structure(
        jax.tree.map(lambda t: 0, it))
    for a, b in zip(optim.tree_leaves(it), jax.tree.leaves(rdovae_params)):
        assert tuple(a.shape) == b.shape
    np.testing.assert_array_equal(it["quant_embed"]["e"].numpy(),
                                  rdovae_params["quant_embed"]["e"])


# ---------------------------------------------------------------- plc_task

def test_plc_loss_and_grads_match_jax():
    """make_batch with JAX's Burg-dropout draw passed in, then loss_fn at
    PLCConfig(): the batch exact, the loss within LOSS_RTOL, every
    gradient leaf within GRAD_REL."""
    params = _np(j_plc.init_params(jax.random.PRNGKey(1), j_plc.PLCConfig()))
    rs = np.random.RandomState(4)
    B, T = 2, 12
    feats = rs.randn(B, T, 56).astype(np.float32)
    lost = (rs.uniform(size=(B, T)) > 0.3).astype(np.int64)
    rng = jax.random.PRNGKey(9)
    draw = np.asarray(jax.random.uniform(jax.random.split(rng)[0],
                                         (B, T, 1)))
    bj = j_plct.make_batch(rng, jnp.asarray(feats), jnp.asarray(lost))
    bt = t_plct.make_batch(torch.as_tensor(draw), torch.as_tensor(feats),
                           torch.as_tensor(lost))
    for k in bj:
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: j_plct.loss_fn(p, bj), has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    (lt, _), gt = optim.value_and_grad(
        lambda p: t_plct.loss_fn(p, bt, t_plc.PLCConfig()),
        convert.params_from_numpy(params, "cpu"))
    print(f"\nplc loss: port {float(lt):.8f} jax {float(lj):.8f}")
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    _assert_grads(gt, gj, "plc")


# ---------------------------------------------------------------- vq_train

def test_lloyd_pass_matches_jax():
    """One Lloyd pass from the same codebook, no empty cell: the same
    assignments, centroids within 1e-5."""
    x = FEATS[:, 1:18].copy()
    cb = x[::25][:8].copy()                    # data points: no empty cell
    aj = np.asarray(j_vq._assign_chunked(jnp.asarray(x), jnp.asarray(cb)))
    at = t_vq._assign_chunked(torch.as_tensor(x), torch.as_tensor(cb))
    np.testing.assert_array_equal(at.numpy(), aj)
    assert len(np.unique(aj)) == cb.shape[0]
    cj = np.asarray(j_vq._lloyd_pass(jnp.asarray(cb), jax.random.PRNGKey(0),
                                     jnp.asarray(x)))
    ct = t_vq._lloyd_pass(torch.as_tensor(cb), torch.Generator(),
                          torch.as_tensor(x))
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-5)


def test_codec_codebooks_have_jax_shapes_and_distortion_falls():
    """train_codec_codebooks gives JAX's codebook shapes (jax.eval_shape of
    its recipe); each stage of the cascade lowers the residual energy, and
    Lloyd passes lower a codebook's distortion."""
    x = torch.as_tensor(FEATS)
    cbs = t_vq.train_codec_codebooks(torch.Generator().manual_seed(0), x,
                                     iters=1, final_iters=1)
    want = jax.eval_shape(
        lambda f: j_vq.train_codec_codebooks(jax.random.PRNGKey(0), f, 1, 1),
        jax.ShapeDtypeStruct(FEATS.shape, jnp.float32))
    assert {k: tuple(v.shape) for k, v in cbs.items()} == {
        k: v.shape for k, v in want.items()}
    r = x[:, 1:18]
    energies = [float((r * r).sum())]
    for name in ("cb1", "cb2", "cb3"):
        r = r - cbs[name][t_vq._assign_chunked(r, cbs[name])]
        energies.append(float((r * r).sum()))
    # 200 frames for 1024 cells: cb1 alone reaches every frame
    assert energies[1] < energies[0] and all(
        b <= a for a, b in zip(energies, energies[1:])), energies

    def distortion(cb):
        d = x[:, 1:18] - cb[t_vq._assign_chunked(x[:, 1:18], cb)]
        return float((d * d).sum())

    few = t_vq.kmeans(torch.Generator().manual_seed(1), x[:, 1:18], 16, 1, 0)
    more = t_vq.kmeans(torch.Generator().manual_seed(1), x[:, 1:18], 16, 1, 6)
    assert distortion(more) < distortion(few)


# --------------------------------------------------------------------- CLI

def test_train_plc_rdovae_and_vq_train_commands(tmp_path):
    """train-plc, train-rdovae (cond 32/32) and vq-train with --device cpu
    on tiny inputs: checkpoints and metrics lines written, a resume
    continues the step count, the codebook blob holds JAX's names and
    shapes."""
    rs = np.random.RandomState(2)
    f56 = tmp_path / "p.f32"
    rs.randn(80, 56).astype(np.float32).tofile(f56)
    out = str(tmp_path / "plc")
    args = ["train-plc", str(f56), out, "--seq-len", "20", "--batch-size",
            "2", "--steps-per-epoch", "1", "--epochs", "1", "--device",
            "cpu"]
    assert t_cli.main(args) == 0
    assert t_cli.main(args + ["--resume",
                              os.path.join(out, "ckpt_000.bin")]) == 0
    assert t_ck.load_training(os.path.join(out, "ckpt_001.bin"))[2] == 2
    f36 = tmp_path / "r.f32"
    FEATS[:64].tofile(f36)
    out = str(tmp_path / "rdovae")
    assert t_cli.main(["train-rdovae", str(f36), out, "--seq-len", "16",
                       "--batch-size", "2", "--steps-per-epoch", "1",
                       "--epochs", "1", "--cond-size", "32", "--cond-size2",
                       "32", "--device", "cpu"]) == 0
    params, _, step, meta = t_ck.load_training(
        os.path.join(out, "ckpt_000.bin"))
    assert step == 1 and meta["cond_size"] == 32
    assert params["enc"]["gru2"]["wr"].shape == (32, 96)
    cb = str(tmp_path / "cb.bin")
    assert t_cli.main(["vq-train", str(f36), cb, "--iters", "1",
                       "--final-iters", "1", "--device", "cpu"]) == 0
    from lpcnet_tpu_torch.utils import weights_io
    shapes = {k: v.shape for k, v in weights_io.load_params(cb).items()}
    assert shapes == {"cb1": (1024, 17), "cb2": (1024, 17),
                      "cb3": (1024, 17), "diff4": (4096, 18)}
