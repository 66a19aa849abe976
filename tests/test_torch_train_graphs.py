"""The training steps as graphed entry points, on the CPU: the optimizer's
state as device tensors (against optax), one argument signature for every
step of a run (so that one capture serves it), and steps that read
nothing from the host and upload nothing to the device. The captures
themselves need the card: tests/test_torch_cuda.py (-m cuda -k train)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.training import lpcnet_task as j_lpct
from lpcnet_tpu.training import plc_task as j_plct
from lpcnet_tpu.training import rdovae_task as j_rdt
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.models import lpcnet, plc, rdovae
from lpcnet_tpu_torch.training import (lpcnet_task, optim, plc_task,
                                       rdovae_task)
from lpcnet_tpu_torch.utils import graphs

# (the JAX optimizer, the port's) of each trainer, decay raised so that the
# schedule moves within 3 steps
OPTIMIZERS = {
    "lpcnet": (j_lpct.make_optimizer(lr=1e-3, decay=0.05, b1=0.5, b2=0.8),
               lpcnet_task.make_optimizer(lr=1e-3, decay=0.05, b1=0.5,
                                          b2=0.8)),
    "plc": (j_plct.make_optimizer(lr=2e-3, decay=0.05),
            plc_task.make_optimizer(lr=2e-3, decay=0.05)),
    "rdovae": (j_rdt.make_optimizer(lr=1e-3, decay=0.1),
               rdovae_task.make_optimizer(lr=1e-3, decay=0.1)),
}


def _is_count(t, device) -> bool:
    return (isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.shape == () and t.device == device)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_scheduled_adam_state_on_the_device_matches_optax(name):
    """Each trainer's ScheduledAdam against optax's chain over 3 steps on
    the same gradients (params and every state leaf within 1e-6, as
    test_torch_train_lpcnet.py holds the LPCNet one); the two counts are
    0-d int32 tensors on the parameters' device from init on, and the
    state goes through state_leaves and state_from_leaves unchanged."""
    opt_j, opt_t = OPTIMIZERS[name]
    rs = np.random.RandomState(7)
    params_np = {"a": {"w": rs.randn(6, 4).astype(np.float32)},
                 "b": rs.randn(5).astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, params_np)
    sj = opt_j.init(pj)
    pt = convert.params_from_numpy(params_np, "cpu")
    st = opt_t.init(pt)
    cpu = torch.device("cpu")
    assert _is_count(st["count"], cpu) and _is_count(st["sched_count"], cpu)
    for _ in range(3):
        g = jax.tree.map(lambda a: (rs.randn(*a.shape) * 10.0 ** rs.uniform(
            -4, 0)).astype(np.float32), params_np)
        uj, sj = opt_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = jax.tree.map(lambda a, b: a + b, pj, uj)
        pt, st = opt_t.apply(pt, convert.params_from_numpy(g, "cpu"), st)
        for a, b in zip(optim.tree_leaves(pt) + optim.state_leaves(st),
                        jax.tree.leaves(pj) + jax.tree.leaves(sj)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.abs(np.asarray(a, np.float64)
                          - np.asarray(b)).max() <= 1e-6
    assert _is_count(st["count"], cpu) and _is_count(st["sched_count"], cpu)
    assert int(st["count"]) == int(st["sched_count"]) == 3
    leaves = optim.state_leaves(st)
    back = optim.state_from_leaves(leaves, pt)
    assert _is_count(back["count"], cpu) and int(back["count"]) == 3
    assert _is_count(back["sched_count"], cpu)
    for a, b in zip(leaves, optim.state_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _lpcnet_run():
    """(the jit, the initial params, the optimizer, a function of the
    last step's params and state giving the next step's arguments) of the
    LPCNet trainer at a narrow width with a noise generator; _plc_run and
    _rdovae_run give the same of the other two."""
    cfg = lpcnet.LPCNetConfig(gru_a_units=32, gru_b_units=8, cond_size=16,
                              embed_sig_size=8, embed_pitch_size=8)
    rs = np.random.RandomState(0)
    batch = {"sig_in": torch.as_tensor(rs.randn(2, 320) * 1000,
                                       dtype=torch.float32),
             "sig_out": torch.as_tensor(rs.randn(2, 320) * 1000,
                                        dtype=torch.float32),
             "features": torch.as_tensor(rs.randn(2, 6, 20) * .3,
                                         dtype=torch.float32),
             "periods": torch.as_tensor(rs.randint(33, 255, (2, 6)),
                                        dtype=torch.int32),
             "lpc": torch.as_tensor(rs.randn(2, 2, 16) * .1,
                                    dtype=torch.float32)}
    opt = lpcnet_task.make_optimizer()
    gen = torch.Generator().manual_seed(1)

    def args(p, s):
        return (p, s, batch, cfg, opt, gen)

    return (lpcnet_task.train_step,
            lpcnet.init_params(torch.Generator().manual_seed(0), cfg), opt,
            args)


def _plc_run():
    cfg = plc.PLCConfig()
    rs = np.random.RandomState(1)
    feats = torch.as_tensor(rs.randn(2, 12, 56), dtype=torch.float32)
    lost = torch.as_tensor(rs.uniform(size=(2, 12)) > 0.3)
    opt = plc_task.make_optimizer()
    gen = torch.Generator().manual_seed(1)

    def args(p, s):
        return (p, s, plc_task.make_batch(gen, feats, lost), cfg, opt)

    return (plc_task.train_step,
            plc.init_params(torch.Generator().manual_seed(0), cfg), opt,
            args)


def _rdovae_run():
    cfg = rdovae.RDOVAEConfig(cond_size=32, cond_size2=32)
    feats = torch.as_tensor(np.random.RandomState(2).randn(2, 16, 20) * .3,
                            dtype=torch.float32)
    opt = rdovae_task.make_optimizer()
    gen = torch.Generator().manual_seed(1)

    def args(p, s):
        # the level drawn between steps from the generator the step's
        # noise comes from, as the train-rdovae command draws it
        q, lam = rdovae_task.sample_lambda(gen, 2, 8)
        return (p, s, feats, q, lam, gen, cfg, opt)

    params = rdovae.init_params(torch.Generator().manual_seed(0), cfg)
    return (rdovae_task.train_step, rdovae.rate_aware_quant_init(params, cfg),
            opt, args)


RUNS = {"lpcnet": _lpcnet_run, "plc": _plc_run, "rdovae": _rdovae_run}


@contextlib.contextmanager
def _no_host_traffic(monkeypatch):
    """Inside, a host read of a tensor's value or a tensor made from host
    data raises: what a CUDA graph cannot capture (a sync or a pageable
    copy in every call)."""
    def refuse(what, keep=None):
        def f(*a, **k):
            if keep is not None and isinstance(a[0], torch.Tensor):
                return keep(*a, **k)        # a tensor already: no upload
            raise AssertionError(f"{what} inside a training step")
        return f

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "cpu", "__float__",
                     "__int__", "__bool__", "new_tensor"):
            m.setattr(torch.Tensor, name, refuse("Tensor." + name))
        for name in ("as_tensor", "tensor", "from_numpy"):
            m.setattr(torch, name, refuse("torch." + name,
                                          getattr(torch, name)))
        yield


@pytest.mark.parametrize("name", sorted(RUNS))
def test_train_step_is_a_jit_with_one_signature_per_run(name, monkeypatch):
    """Each trainer's train_step is a graphs.jit entry point named after
    it; the arguments of step 1 and step 3 of a run have one signature
    (the optimizer's counts are tensors, cfg and opt static, the generator
    the same object), so on the card one capture serves the run. On the
    CPU the steps run eagerly and nothing is captured. After the first
    step (it makes the device constants), a step reads no tensor's value
    on the host and makes no tensor from host data."""
    step, params, opt, args = RUNS[name]()
    assert isinstance(step, graphs.jit)
    assert step.name == f"{name}_task.train_step"
    state = opt.init(params)
    graphs.captures.clear()
    keys, losses = [], []
    for k in range(3):
        a = args(params, state)
        keys.append(graphs.signature(a))
        with _no_host_traffic(monkeypatch) if k else contextlib.nullcontext():
            params, state, metrics = step(*a)
        losses.append(float(metrics["loss"]))
    assert keys[0] == keys[2] and keys[1] == keys[2]
    assert int(state["count"]) == int(state["sched_count"]) == 3
    assert np.isfinite(losses).all()
    assert not graphs.captures and step.steps == {}
