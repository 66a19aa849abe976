"""The port's plain sample loop (lpcnet_tpu_torch/kernels/sample_scan.py)
and the CPU side of the frame-kernel wrapper (kernels/sample_cuda.py)
against the JAX package's lax.scan loop and its Pallas kernel in interpret
mode, with the setup of tests/test_pallas_kernel.py (random-init weights at
full width, B=4, T=2, per-stream RNG).

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
                                      variant="opt")


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
