"""The port's plain sample loop (lpcnet_tpu_torch/kernels/sample_scan.py)
and the CPU side of the kernel wrappers (kernels/sample_cuda.py) against
the JAX package's lax.scan loop and its Pallas kernels in interpret mode,
with the setup of tests/test_pallas_kernel.py (random-init weights at full
width, B=4, T=2, per-stream RNG).

Gate of lpcnet_tpu/verify.py for free-run synthesis: rng state exact, pcm
exact fraction >= 0.95, correlation >= 0.999. The loops sum in different
orders, so a float near-tie can flip one sample and the autoregressive
loop then drifts; the gate bounds how often that may happen."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.constants import NB_TOTAL_FEATURES
from lpcnet_tpu.kernels import sample_pallas, sample_scan as j_scan
from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.vocoder import Synthesizer as JSynthesizer
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan as t_scan
from lpcnet_tpu_torch.models import lpcnet as t_lpcnet

CFG_J = j_lpcnet.LPCNetConfig()
CFG_T = t_lpcnet.LPCNetConfig()


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain loops are thousands of small operations: more intra-op
    threads only spin and slow the other test workers down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch_state(st):
    out = {k: torch.as_tensor(np.array(v)) for k, v in st.items()}
    out["rng"] = torch.as_tensor(np.asarray(st["rng"]).astype(np.int64))
    return out


def _gate(pcm, ref, rng, ref_rng):
    pcm, ref = np.asarray(pcm), np.asarray(ref)
    assert np.array_equal(np.asarray(rng).astype(np.int64),
                          np.asarray(ref_rng).astype(np.int64))
    exact = (pcm == ref).mean()
    corr = np.corrcoef(pcm.ravel(), ref.ravel())[0, 1]
    assert exact >= 0.95 and corr >= 0.999, (exact, corr)


@pytest.fixture(scope="module")
def setup():
    voc = JSynthesizer(CFG_J, rng=jax.random.PRNGKey(11))
    rs = np.random.RandomState(5)
    B, T = 4, 2
    f = np.zeros((B, T, NB_TOTAL_FEATURES), np.float32)
    f[..., :18] = rs.randn(B, T, 18) * 0.3
    f[..., 18] = rs.uniform(-1, 1, (B, T))
    f[..., 19] = rs.uniform(0, 1, (B, T))
    conds = voc.conditions(jnp.asarray(f))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, voc.params),
                                       "cpu")
    tables = t_lpcnet.precompute_sample_tables(params, CFG_T)
    tconds = {k: torch.as_tensor(np.array(conds[k]))
              for k in ("cond_a", "cond_b", "lpc")}
    state = voc.reset(B, per_stream_rng=True)
    flat = t_scan.synthesize_frames(tables, _to_torch_state(state), tconds,
                                    CFG_T, flat=True)
    return voc, conds, state, tables, tconds, flat


def test_init_state_matches(setup):
    voc, _, state, _, _, _ = setup
    from lpcnet_tpu_torch.ops import kiss99
    st = t_scan.init_state(4, CFG_T, kiss99.batched_seed(4, per_stream=True))
    for k in state:
        np.testing.assert_array_equal(st[k].numpy(),
                                      np.asarray(state[k]).astype(
                                          st[k].numpy().dtype), err_msg=k)


@pytest.mark.parametrize("flat", [False, True])
def test_sample_step_matches_jax(setup, flat):
    """One step from an identical warmed-up state: exc and rng exact, pcm
    within 1 (rounding of floor(.5+x) after float sums in another order)."""
    voc, conds, state, tables, tconds, _ = setup
    cond = {k: conds[k][:, 0] for k in ("cond_a", "cond_b", "lpc")}
    warm, _ = j_scan.synth_samples(voc.tables, state, cond, CFG_J, 23)
    st_j, out_j = j_scan.sample_step(voc.tables, warm, cond["cond_a"],
                                     cond["cond_b"], cond["lpc"],
                                     CFG_J.approx, CFG_J.preemph)
    st_t, out_t = t_scan.sample_step(
        tables, _to_torch_state(warm), tconds["cond_a"][:, 0],
        tconds["cond_b"][:, 0], tconds["lpc"][:, 0], CFG_T.approx,
        CFG_T.preemph, flat=flat)
    np.testing.assert_array_equal(st_t["last_exc"].numpy(),
                                  np.asarray(st_j["last_exc"]))
    np.testing.assert_array_equal(st_t["rng"].numpy(),
                                  np.asarray(st_j["rng"]).astype(np.int64))
    assert np.abs(out_t.numpy() - np.asarray(out_j)).max() <= 1
    # float state: sums of 384 products in another order
    np.testing.assert_allclose(st_t["gru_a"].numpy(),
                               np.asarray(st_j["gru_a"]), atol=1e-5)


def test_synthesize_frames_matches_scan(setup):
    voc, conds, state, _, _, (st_t, pcm_t) = setup
    st_j, pcm_j = j_scan.synthesize_frames(voc.tables, state, conds, CFG_J)
    assert pcm_t.shape == (4, 320)
    _gate(pcm_t.numpy(), pcm_j, st_t["rng"].numpy(), st_j["rng"])


def test_synthesize_frames_matches_pallas_interpret(setup):
    voc, conds, state, _, _, (st_t, pcm_t) = setup
    st_p, pcm_p = sample_pallas.synthesize_frames_pallas(
        voc.tables, state, conds, CFG_J, interpret=True, variant="flat")
    _gate(pcm_t.numpy(), pcm_p, st_t["rng"].numpy(), st_p["rng"])


def test_plain_flat_and_walk_bit_identical(setup):
    _, _, state, tables, tconds, (st_f, pcm_f) = setup
    st_w, pcm_w = t_scan.synthesize_frames(tables, _to_torch_state(state),
                                           tconds, CFG_T, flat=False)
    assert torch.equal(pcm_w, pcm_f)
    for k in st_f:
        assert torch.equal(st_w[k], st_f[k]), k


def test_wrapper_on_cpu_runs_plain_version(setup):
    """A CPU tensor takes the plain version; the kernel's launch count
    stays where it was."""
    _, _, state, tables, tconds, (st_f, pcm_f) = setup
    before = dict(sample_cuda.launches)
    st, pcm = sample_cuda.synthesize_frame(
        tables, _to_torch_state(state), tconds["cond_a"][:, 0],
        tconds["cond_b"][:, 0], tconds["lpc"][:, 0], CFG_T, variant="flat")
    assert sample_cuda.launches == before
    assert torch.equal(pcm, pcm_f[:, :160])
    with pytest.raises(ValueError):
        sample_cuda.synthesize_frames(tables, st, tconds, CFG_T,
                                      variant="fast")


def test_seq_dot_is_a_matmul():
    # 1e-5: the kernel-order sums are a plain product up to float rounding
    rs = np.random.RandomState(6)
    x = torch.as_tensor(rs.randn(3, 384).astype(np.float32))
    w = torch.as_tensor(rs.randn(384, 48).astype(np.float32))
    ref = (x.double() @ w.double()).float()
    torch.testing.assert_close(t_scan.seq_dot(x, w), ref, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(t_scan.sliced_dot(x, w), ref, rtol=1e-5,
                               atol=1e-4)


# ---- synth_samples (K3's function) and teacher_advance (K4's), full width

# the argument sets the JAX package's engines pass: (nsamples, target,
# preload, force_from, n_active)
FLAG_SETS = {
    "free80": (80, False, False, False, False),
    "target": (80, True, False, False, False),
    "target_preload": (80, True, True, False, False),
    "target_force_from": (160, True, False, True, False),
    "target_force_from_n_active": (80, True, False, True, True),
    "n_active": (80, False, False, False, True),
}


def _flag_args(name, batch):
    ns, has_target, has_pre, has_ff, has_act = FLAG_SETS[name]
    rs = np.random.RandomState(3)
    kw = {}
    if has_target:
        kw["target"] = np.round(rs.randn(batch, ns) * 2500).astype(np.float32)
    if has_pre:
        kw["preload"] = rs.randint(0, ns + 1, batch).astype(np.int32)
    if has_ff:
        kw["force_from"] = rs.randint(ns // 4, ns + 1, batch).astype(np.int32)
    if has_act:
        kw["n_active"] = rs.randint(0, ns + 1, batch).astype(np.int32)
    return ns, kw


@pytest.fixture(scope="module")
def warm(setup):
    """A state warmed by 23 free-run steps, so that no leaf is trivial, and
    the second frame's conditions."""
    voc, conds, state, tables, tconds, _ = setup
    cond0 = {k: conds[k][:, 0] for k in ("cond_a", "cond_b", "lpc")}
    st, _ = j_scan.synth_samples(voc.tables, state, cond0, CFG_J, 23)
    cond = {k: conds[k][:, 1] for k in ("cond_a", "cond_b", "lpc")}
    tcond = {k: tconds[k][:, 1] for k in ("cond_a", "cond_b", "lpc")}
    return voc, tables, st, cond, tcond


def _rows(tree, batch):
    return {k: v[:batch] for k, v in tree.items()}


def _assert_state(st_t, st_j):
    """rng, last_exc exact; GRU states to 1e-5 (384 products summed in
    another order); last_sig and deemph to 1e-6 of the int16 range: they
    are the unrounded signal, whose last bits differ where XLA's CPU code
    contracts a multiply and an add, and the de-emphasis recurrence
    (gain 1/0.15) carries such ulps along; the rounded pcm is exact."""
    np.testing.assert_array_equal(st_t["rng"].numpy(),
                                  np.asarray(st_j["rng"]).astype(np.int64))
    np.testing.assert_array_equal(st_t["last_exc"].numpy(),
                                  np.asarray(st_j["last_exc"]))
    for k in ("gru_a", "gru_b"):
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   atol=1e-5, err_msg=k)
    for k in ("last_sig", "deemph"):
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   rtol=0, atol=0.03, err_msg=k)


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_synth_samples_matches_jax(warm, flags, batch):
    """Every argument set through the port's plain loop (walked and flat
    sampler), JAX scan and the JAX Pallas kernel in interpret mode: the
    excitation and the rng exact, pcm equal but for rounding flips of
    floor(.5 + x) by 1 on at most 1% of the samples (measured: 1 sample of
    320 in the free-run part of the two force_from sets, none elsewhere;
    the loops sum in different orders)."""
    voc, tables, st, cond, tcond = warm
    ns, kw = _flag_args(flags, batch)
    st, cond, tcond = _rows(st, batch), _rows(cond, batch), _rows(tcond,
                                                                  batch)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) for k, v in kw.items()}
    st_j, pcm_j = j_scan.synth_samples(voc.tables, st, cond, CFG_J, ns,
                                       **jkw)
    st_p, pcm_p = sample_pallas.synth_samples_pallas(
        voc.tables, st, cond, CFG_J, ns, interpret=True, variant="flat",
        **jkw)
    before = dict(sample_cuda.launches)
    st_t, pcm_t = sample_cuda.synth_samples(
        tables, _to_torch_state(st), tcond, CFG_T, ns, variant="flat", **tkw)
    assert sample_cuda.launches == before
    assert pcm_t.shape == (batch, ns)
    for name, ref, st_ref in (("scan", pcm_j, st_j), ("pallas", pcm_p, st_p)):
        d = np.abs(pcm_t.numpy() - np.asarray(ref))
        print(f"{flags} B={batch} vs {name}: pcm max |d| {d.max()}, exact "
              f"{(d == 0).mean():.6f}; " + ", ".join(
                  f"{k} max |d| "
                  f"{np.abs(st_t[k].numpy() - np.asarray(st_ref[k])).max():.3g}"
                  for k in ("gru_a", "gru_b", "last_sig", "deemph")))
        assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(),
                                                          (d == 0).mean())
    _assert_state(st_t, st_j)
    _assert_state(st_t, st_p)
    if "n_active" in kw:
        for b in range(batch):
            assert not pcm_t[b, int(kw["n_active"][b]):].any()


def test_synth_samples_walked_sampler_same_bits(warm):
    voc, tables, st, cond, tcond = warm
    ns, kw = _flag_args("target_force_from_n_active", 4)
    tkw = {k: torch.as_tensor(v) for k, v in kw.items()}
    flat = t_scan.synth_samples(tables, _to_torch_state(st), tcond, CFG_T,
                                ns, flat=True, **tkw)
    walk = t_scan.synth_samples(tables, _to_torch_state(st), tcond, CFG_T,
                                ns, flat=False, **tkw)
    assert torch.equal(flat[1], walk[1])
    for k in flat[0]:
        assert torch.equal(flat[0][k], walk[0][k]), k


@pytest.mark.parametrize("batch", [2, 4])
def test_teacher_advance_matches_jax(warm, batch):
    """teacher_advance against the JAX package's (scan and the Pallas
    kernel in interpret mode), and within the port against the fully forced
    sample loop: every state leaf exact."""
    voc, tables, st, cond, tcond = warm
    ns, kw = _flag_args("target_force_from", batch)
    st, cond, tcond = _rows(st, batch), _rows(cond, batch), _rows(tcond,
                                                                  batch)
    tgt = torch.as_tensor(kw["target"])
    st_j, _ = j_scan.teacher_advance(voc.tables, st, cond, CFG_J,
                                     jnp.asarray(kw["target"]))
    st_p, _ = sample_pallas.teacher_advance_pallas(
        voc.tables, st, cond, CFG_J, jnp.asarray(kw["target"]),
        interpret=True)
    before = dict(sample_cuda.launches)
    st_t, out = sample_cuda.teacher_advance(tables, _to_torch_state(st),
                                            tcond, CFG_T, tgt)
    assert sample_cuda.launches == before
    assert out is tgt
    _assert_state(st_t, st_j)
    _assert_state(st_t, st_p)
    st_f, pcm_f = t_scan.synth_samples(tables, _to_torch_state(st), tcond,
                                       CFG_T, ns, target=tgt)
    assert torch.equal(pcm_f, tgt)
    for k in st_f:
        assert torch.equal(st_t[k], st_f[k]), k


@pytest.mark.parametrize("batch", [2, 4])
def test_plain_teacher_advance_equals_forced_synth_samples(warm, batch):
    """The identity the K4 kernel rests on (csrc/teacher_advance.cu runs the
    sample loop's forced step without its tail): the plain teacher_advance
    (teacher_sequences, the GRU recurrences, the KISS99 jump) leaves every
    state field of the plain fully forced synth_samples, bit for bit, at
    full width, on a warmed state."""
    _, tables, st, _, tcond = warm
    ns, kw = _flag_args("target", batch)
    state = _to_torch_state(_rows(st, batch))
    tcond = _rows(tcond, batch)
    tgt = torch.as_tensor(kw["target"])
    st_t, out = t_scan.teacher_advance(tables, state, tcond, CFG_T, tgt)
    st_f, pcm_f = t_scan.synth_samples(tables, state, tcond, CFG_T, ns,
                                       target=tgt)
    assert out is tgt and torch.equal(pcm_f, tgt)
    assert set(st_t) == set(st_f) == {"gru_a", "gru_b", "last_sig",
                                      "last_exc", "deemph", "rng"}
    for k in st_f:
        assert torch.equal(st_t[k], st_f[k]), k


def test_sliced_dot_names_the_width_it_needs():
    with pytest.raises(ValueError, match="multiple"):
        t_scan.sliced_dot(torch.zeros((1, 64)), torch.zeros((64, 48)))
