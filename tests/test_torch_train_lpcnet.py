"""The port's LPCNet training (lpcnet_tpu_torch/training: losses,
lpcnet_task, optim, sparsify; utils/checkpoint.save_training;
models/*.init_params) against the JAX package's on the same inputs:
seeded numpy arrays and JAX's init_params at the small config of
tests/test_training.py (GRU-A 64, GRU-B 16, cond 32, embeddings 16/8,
40-sample frames, 3 frames per chunk).

Gates: the loss functions' values and the training loss relative 1e-5;
every gradient (of a loss function's inputs, or leaf of the parameters)
max |d| <= 1e-4 * max |g_jax| (noise off, non-e2e and e2e). The loss
functions' gradients reach 2.1e-5 of their largest entry: l2u's exact log
differs from XLA's by an ulp on ~2% of the elements (1.5e-5 at e ~ 200),
and the interpolated CE's weight alpha = e - floor(e) carries that whole;
the optimizer on identical gradients 1e-6 per leaf; weight_clip 1e-7;
sparsify masks and progressive_quantize exact. The measured values are
printed (-s) and quoted in PERF.md.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.training import losses as j_losses
from lpcnet_tpu.training import lpcnet_task as j_task
from lpcnet_tpu.training import sparsify as j_sp
from lpcnet_tpu.utils import checkpoint as j_ck
from lpcnet_tpu_torch import cli as t_cli
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.models import lpcnet as t_lpcnet
from lpcnet_tpu_torch.training import losses as t_losses
from lpcnet_tpu_torch.training import lpcnet_task as t_task
from lpcnet_tpu_torch.training import optim
from lpcnet_tpu_torch.training import sparsify as t_sp
from lpcnet_tpu_torch.utils import checkpoint as t_ck

HERE = os.path.dirname(__file__)
SMALL = dict(gru_a_units=64, gru_b_units=16, cond_size=32, embed_sig_size=16,
             embed_pitch_size=8, frame_size=40)
CFG_J = j_lpcnet.LPCNetConfig(**SMALL)
CFG_T = t_lpcnet.LPCNetConfig(**SMALL)
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


def _batch(B=4, T=3, seed=0):
    """tests/test_training.py's batch: minimum-phase LPC from reflection
    coefficients, random signals, features and periods."""
    rs = np.random.RandomState(seed)
    S = T * CFG_J.frame_size
    rc = np.tanh(rs.randn(B, T, 16)).astype(np.float32) * 0.6
    return {
        "sig_in": rs.randn(B, S).astype(np.float32) * 1000,
        "sig_out": rs.randn(B, S).astype(np.float32) * 1000,
        "features": rs.randn(B, T + 4, 20).astype(np.float32) * 0.3,
        "periods": rs.randint(33, 255, (B, T + 4)).astype(np.int32),
        "lpc": np.asarray(j_losses.rc2lpc(jnp.asarray(rc))),
    }


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def params_np():
    return _np(j_lpcnet.init_params(jax.random.PRNGKey(0), CFG_J))


def _grad_errors(g_t, g_j):
    """{path: (max |d|, max |g_jax|)} over the gradient leaves."""
    out = {}
    for (path, gj), gt in zip(
            jax.tree_util.tree_flatten_with_path(g_j)[0],
            optim.tree_leaves(g_t)):
        gj = np.asarray(gj)
        out[jax.tree_util.keystr(path)] = (
            float(np.abs(gt.numpy() - gj).max()), float(np.abs(gj).max()))
    return out


def _assert_grads(g_t, g_j, what):
    errs = _grad_errors(g_t, g_j)
    worst = max(d / max(m, 1e-30) for d, m in errs.values())
    print(f"\n{what}: worst gradient leaf max|d| / max|g| = {worst:.3e}")
    for k, (d, m) in errs.items():
        assert d <= GRAD_REL * m, (k, d, m)


# ------------------------------------------------------------------ losses

def _loss_inputs(seed=5):
    rs = np.random.RandomState(seed)
    sig = (rs.randn(2, 80) * 3000).astype(np.float32)
    sig[0, :4] = 0.0                                      # abs/sign ties
    sig[1, :2] = (40000.0, -40000.0)                      # saturated mu-law
    preds = (rs.randn(2, 80) * 2000).astype(np.float32)
    logits = rs.randn(2, 80, 256).astype(np.float32)
    pdf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    rc = (np.tanh(rs.randn(2, 3, 16)) * 0.7).astype(np.float32)
    lpc = np.asarray(j_losses.rc2lpc(jnp.asarray(rc)))
    return sig, preds, pdf.astype(np.float32), rc, lpc


LOSS_CASES = {
    "l2u": lambda L, s, p, d, r, a: L.l2u(s),
    "u2l": lambda L, s, p, d, r, a: L.u2l(L.l2u(s)),
    "diff_pred": lambda L, s, p, d, r, a: L.diff_pred(s, a[:, :2], 40),
    "rc2lpc": lambda L, s, p, d, r, a: L.rc2lpc(r),
    "tree_to_pdf": lambda L, s, p, d, r, a: L.tree_to_pdf(d),
    "metric_cel": lambda L, s, p, d, r, a: L.metric_cel(s, p, d),
    "metric_icel": lambda L, s, p, d, r, a: L.metric_icel(s, p, d),
    "interp_mulaw": lambda L, s, p, d, r, a: L.interp_mulaw(s, p, 0.9 * p,
                                                            d, 2.0),
    "metric_exc_sd": lambda L, s, p, d, r, a: L.metric_exc_sd(s, p),
    "loss_matchlar": lambda L, s, p, d, r, a: L.loss_matchlar(0.5 * r, r),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax_with_grad(name):
    """Each loss function's value, and the gradient of a fixed random
    weighting of it with respect to every float input, on inputs with
    exact zeros and saturated samples."""
    fn = LOSS_CASES[name]
    ins = _loss_inputs()
    out = jax.eval_shape(lambda *a: fn(j_losses, *a), *ins)
    w = np.random.RandomState(6).uniform(0.5, 1.5, out.shape).astype(
        np.float32)
    vj, gj = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(fn(j_losses, *a) * w),
        argnums=tuple(range(len(ins)))))(*[jnp.asarray(a) for a in ins])
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    vt = torch.sum(fn(t_losses, *ts) * torch.as_tensor(w))
    gt = torch.autograd.grad(vt, ts, allow_unused=True)
    np.testing.assert_allclose(float(vt.detach()), float(vj),
                               rtol=LOSS_RTOL)
    worst = 0.0
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        d, m = np.abs(a - b).max(), np.abs(b).max()
        worst = max(worst, d / m if m else d)
        assert d <= GRAD_REL * m, (name, d, m)
    rel = abs(float(vt.detach()) / float(vj) - 1)
    print(f"\n{name}: value rel {rel:.2e}, worst gradient max|d| / "
          f"max|g| {worst:.2e}")


def test_lpc2rc_matches_jax_op_by_op():
    """lpc2rc (the step-down of the batch's LPC targets, never
    differentiated in training) equals JAX's op-by-op value bit for bit.
    Under jit XLA reorders the ill-conditioned recursion (9.2e-5 from its
    own eager value on these inputs), so the comparison is eager."""
    lpc = _loss_inputs()[4]
    np.testing.assert_array_equal(
        t_losses.lpc2rc(torch.as_tensor(lpc)).numpy(),
        np.asarray(j_losses.lpc2rc(jnp.asarray(lpc))))


# ------------------------------------------------------------ lpcnet_task

@pytest.mark.parametrize("e2e", [False, True], ids=["ce", "e2e"])
def test_loss_and_grads_match_jax(params_np, e2e):
    """Noise off: the loss within LOSS_RTOL, every gradient leaf within
    GRAD_REL of its largest entry."""
    batch = _batch()
    cj = j_lpcnet.LPCNetConfig(**SMALL, e2e=e2e)
    ct = t_lpcnet.LPCNetConfig(**SMALL, e2e=e2e)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: j_task.loss_fn(p, b, cj), has_aux=True))(
        jax.tree.map(jnp.asarray, params_np), jb)
    (lt, mt), gt = optim.value_and_grad(
        lambda p: t_task.loss_fn(p, _tb(batch), ct),
        convert.params_from_numpy(params_np, "cpu"))
    print(f"\nloss ({'e2e' if e2e else 'ce'}): port {float(lt):.8f} jax "
          f"{float(lj):.8f} rel {abs(float(lt) / float(lj) - 1):.3e}")
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    _assert_grads(gt, gj, "e2e" if e2e else "ce")


def test_injected_noise_matches_jax(params_np):
    """Training noise: JAX's two draws (lpcnet_task.py:106, :119) passed
    in as tensors give JAX's noisy loss."""
    batch = _batch(seed=1)
    key = jax.random.PRNGKey(7)
    _, k1, k2 = jax.random.split(key, 3)
    B, S = batch["sig_in"].shape
    draws = {"cpcm": torch.as_tensor(np.asarray(
        jax.random.normal(k1, (B, S, 3)))),
        "gru_a": torch.as_tensor(np.asarray(
            jax.random.normal(k2, (B, S, CFG_J.gru_a_units))))}
    lj, _ = jax.jit(lambda p, b, k: j_task.loss_fn(p, b, CFG_J, k))(
        jax.tree.map(jnp.asarray, params_np),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    lt, _ = t_task.loss_fn(convert.params_from_numpy(params_np, "cpu"),
                           _tb(batch), CFG_T, draws)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)


def test_weight_clip_matches_jax(params_np):
    p = jax.tree.map(lambda a: a * 3.0, params_np)
    wj = _np(j_task.weight_clip(jax.tree.map(jnp.asarray, p)))
    wt = t_task.weight_clip(convert.params_from_numpy(p, "cpu"))
    for a, b in zip(optim.tree_leaves(wt), jax.tree.leaves(wj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-7)


def test_init_params_tree_matches_jax():
    """Same tree, shapes and dtypes as JAX's init; orthogonal GRU blocks;
    the values differ (other generators)."""
    pt = t_lpcnet.init_params(torch.Generator().manual_seed(0), CFG_T)
    pj = _np(j_lpcnet.init_params(jax.random.PRNGKey(0), CFG_J))
    assert jax.tree.structure(pj) == jax.tree.structure(
        jax.tree.map(lambda t: 0, pt))
    for a, b in zip(optim.tree_leaves(pt), jax.tree.leaves(pj)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    n = CFG_T.gru_a_units
    wr = pt["gru_a"]["wr"].reshape(n, 3, n)
    for g in range(3):
        torch.testing.assert_close(wr[:, g].T @ wr[:, g], torch.eye(n),
                                   atol=1e-5, rtol=0)


def test_port_training_loss_decreases():
    """The port's own train_step (with noise, weight clip) lowers the loss
    on a fixed batch over 8 steps (test_training.py::test_loss_decreases's
    counterpart)."""
    params = t_lpcnet.init_params(torch.Generator().manual_seed(0), CFG_T)
    opt = t_task.make_optimizer(lr=3e-3)
    state = opt.init(params)
    batch = _tb(_batch())
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(8):
        params, state, m = t_task.train_step(params, state, batch, CFG_T,
                                             opt, gen)
        losses.append(float(m["loss"]))
    print(f"\nport losses over 8 steps: {losses}")
    assert losses[-1] < losses[0]


# --------------------------------------------------------------- optimizer

def test_optimizer_matches_optax_on_identical_grads(params_np):
    """3 steps of the port's ScheduledAdam and optax's chain on the same
    numpy gradients, decay > 0: params and every state leaf within 1e-6."""
    rs = np.random.RandomState(3)
    opt_j = j_task.make_optimizer(lr=1e-3, decay=0.05, b1=0.5, b2=0.8)
    opt_t = t_task.make_optimizer(lr=1e-3, decay=0.05, b1=0.5, b2=0.8)
    pj = jax.tree.map(jnp.asarray, params_np)
    sj = opt_j.init(pj)
    pt = convert.params_from_numpy(params_np, "cpu")
    st = opt_t.init(pt)
    worst = 0.0
    for _ in range(3):
        g = jax.tree.map(lambda a: (rs.randn(*a.shape) * 10.0 ** rs.uniform(
            -4, 0)).astype(np.float32), params_np)
        uj, sj = opt_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = jax.tree.map(lambda a, b: a + b, pj, uj)
        pt, st = opt_t.apply(pt, convert.params_from_numpy(g, "cpu"), st)
        for a, b in zip(optim.tree_leaves(pt) + optim.state_leaves(st),
                        jax.tree.leaves(pj) + jax.tree.leaves(sj)):
            d = np.abs(np.asarray(a, np.float64) - np.asarray(b)).max()
            worst = max(worst, d)
            assert d <= 1e-6
    print(f"\noptimizer: worst leaf max|d| over 3 steps {worst:.3e}")
    assert optim.state_leaves(st)[0] == 3 and optim.state_leaves(st)[-1] == 3


# -------------------------------------------------------------- checkpoint

def test_checkpoint_interoperates_both_ways(params_np, tmp_path):
    """A port checkpoint loads in JAX's load_training(path, opt.init(...))
    and a JAX one resumes in the port; one more step from each side equals
    the other framework's step on the same batch (the gradient gate)."""
    batch = _batch(seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt_j = j_task.make_optimizer()
    opt_t = t_task.make_optimizer()
    # two port steps, saved; JAX resumes and steps once more
    pt = convert.params_from_numpy(params_np, "cpu")
    st = opt_t.init(pt)
    for _ in range(2):
        pt, st, _ = t_task.train_step(pt, st, _tb(batch), CFG_T, opt_t)
    path = str(tmp_path / "port.bin")
    t_ck.save_training(path, convert.params_to_numpy(pt),
                       optim.state_leaves(st), 2, {"epoch": 0})
    tpl = opt_j.init(j_lpcnet.init_params(jax.random.PRNGKey(0), CFG_J))
    pj, sj, step, meta = j_ck.load_training(path, tpl)
    assert step == 2 and meta == {"epoch": 0}
    for a, b in zip(optim.tree_leaves(pt) + optim.state_leaves(st),
                    jax.tree.leaves(pj) + jax.tree.leaves(sj)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pj2, sj2, _ = j_task.train_step(jax.tree.map(jnp.asarray, pj), sj, jb,
                                    None, CFG_J, opt_j)
    pt2, st2, _ = t_task.train_step(pt, st, _tb(batch), CFG_T, opt_t)
    _assert_steps_agree(pt2, pj2, opt_t.lr)
    # a JAX checkpoint resumes in the port
    path = str(tmp_path / "jax.bin")
    j_ck.save_training(path, pj2, sj2, 3, {"epoch": 1})
    tree, leaves, step, meta = t_ck.load_training(path)
    pt3 = convert.params_from_numpy(tree, "cpu")
    st3 = optim.state_from_leaves(leaves, pt3)
    assert step == 3 and st3["count"] == 3 and st3["sched_count"] == 3
    pt4, _, _ = t_task.train_step(pt3, st3, _tb(batch), CFG_T, opt_t)
    pj4, _, _ = j_task.train_step(pj2, sj2, jb, None, CFG_J, opt_j)
    _assert_steps_agree(pt4, pj4, opt_t.lr)


def _assert_steps_agree(pt, pj, lr):
    """After one Adam step from equal states, each parameter moved by at
    most lr per entry; a gradient entry near rounding noise can flip its
    update's sign, so the gate is the fraction of entries within 1e-3 of
    a step (>= 0.999) and no entry beyond 2 lr + 1e-6."""
    d = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                        for a, b in zip(optim.tree_leaves(pt),
                                        jax.tree.leaves(pj))])
    close = float((d <= 1e-3 * lr).mean())
    print(f"\nstep from a loaded checkpoint: {close:.6f} of entries within "
          f"1e-3 lr, max |d| {d.max():.3e}")
    assert close >= 0.999 and d.max() <= 2 * lr + 1e-6


# ---------------------------------------------------------------- sparsify

@pytest.mark.parametrize("step", [100, 2400, 2500, 2800, 40000, 50000],
                         ids=lambda s: f"step{s}")
@pytest.mark.parametrize("quantize", [False, True], ids=["sparse", "quant"])
def test_sparsify_matches_jax_exactly(params_np, step, quantize):
    """Masks and progressive quantization on identical weights: before
    t_start (100), at an interval (2400, 2800), between intervals (2500),
    at and after t_end (40000, 50000)."""
    rs = np.random.RandomState(step)
    p = {"gru_a": {"wr": rs.randn(64, 192).astype(np.float32) * 0.2},
         "gru_b": {"wi": rs.randn(96, 48).astype(np.float32) * 0.2}}
    cfg_kw = dict(t_start=2000, t_end=40000, interval=400, quantize=quantize,
                  density=(0.1, 0.2, 0.3), grub_density=(0.5, 0.25, 0.75))
    jo = _np(jax.jit(j_sp.apply, static_argnums=(2, 3))(
        jax.tree.map(jnp.asarray, p), jnp.int32(step),
        j_sp.SparsifyConfig(**cfg_kw), 64))
    to = t_sp.apply(convert.params_from_numpy(p, "cpu"), step,
                    t_sp.SparsifyConfig(**cfg_kw), 64)
    for g, k in (("gru_a", "wr"), ("gru_b", "wi")):
        np.testing.assert_array_equal(to[g][k].numpy(), jo[g][k])


def test_progressive_quantize_matches_jax():
    w = np.random.RandomState(9).randn(64, 48).astype(np.float32) * 0.05
    for step in (10000, 15000, 29999, 30000):
        np.testing.assert_array_equal(
            t_sp.progressive_quantize(torch.as_tensor(w), step, 10000,
                                      30000).numpy(),
            np.asarray(j_sp.progressive_quantize(jnp.asarray(w),
                                                 jnp.int32(step), 10000,
                                                 30000)))


# --------------------------------------------------------------------- CLI

def test_train_lpcnet_cli_runs_and_resumes(tmp_path):
    """train-lpcnet --device cpu at LPCNetConfig() on a tiny corpus: a
    checkpoint and metrics line per epoch; --resume continues the step
    count from the saved parameters bit for bit."""
    feats, data = tmp_path / "f.f32", tmp_path / "d.s16"
    rs = np.random.RandomState(0)
    f = rs.randn(40, 36).astype(np.float32) * 0.3
    f[:, 20:] = 0.0
    f.tofile(feats)
    (rs.randn(40 * 160, 2) * 500).astype(np.int16).tofile(data)
    out = str(tmp_path / "run")
    common = [str(feats), str(data), out, "--batch-size", "1",
              "--steps-per-epoch", "1", "--epochs", "1", "--device", "cpu"]
    assert t_cli.main(["train-lpcnet"] + common) == 0
    saved = t_ck.load_training(os.path.join(out, "ckpt_000.bin"))
    assert saved[2] == 1
    assert t_cli.main(["train-lpcnet"] + common + [
        "--resume", os.path.join(out, "ckpt_000.bin")]) == 0
    tree, leaves, step, meta = t_ck.load_training(
        os.path.join(out, "ckpt_001.bin"))
    assert step == 2 and meta["epoch"] == 1 and int(leaves[0]) == 2
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 2 and '"wall_s"' in lines[0]


def test_training_commands_need_the_card_by_default(tmp_path):
    """Without --device the commands ask for the card; on a host without
    one that is an error, never a quiet move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; tests/test_torch_cuda.py runs "
                    "the commands there")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["vq-train", os.path.join(HERE, "golden",
                                             "ref_feats.f32"),
                    str(tmp_path / "cb.bin")])
