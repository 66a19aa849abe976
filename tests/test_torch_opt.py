"""The plain version of the fused frame kernel
(lpcnet_tpu_torch/kernels/sample_scan.py::synthesize_frames_opt, variants
'fuse' and 'opt') against the port's walked-tree loop, bit for bit, and at
full width against the JAX package's Pallas kernel in interpret mode
(sample_pallas.py::_frame_kernel_opt), with the setup of
tests/test_torch_sample.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.constants import NB_TOTAL_FEATURES
from lpcnet_tpu.kernels import sample_pallas
from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.vocoder import Synthesizer as JSynthesizer
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan as t_scan
from lpcnet_tpu_torch.models import lpcnet as t_lpcnet

CFG_J = j_lpcnet.LPCNetConfig()
CFG_T = t_lpcnet.LPCNetConfig()
# a narrow model for the bit-for-bit cases (GRU-A 96 = 2 slices of 48)
NARROW = dict(gru_a_units=96, cond_size=32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain loops are thousands of small operations: more intra-op
    threads only spin and slow the other test workers down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(rs, batch, frames):
    f = np.zeros((batch, frames, NB_TOTAL_FEATURES), np.float32)
    f[..., :18] = rs.randn(batch, frames, 18) * 0.3
    f[..., 18] = rs.uniform(-1, 1, (batch, frames))
    f[..., 19] = rs.uniform(0, 1, (batch, frames))
    return f


def _to_torch_state(st):
    out = {k: torch.as_tensor(np.array(v)) for k, v in st.items()}
    out["rng"] = torch.as_tensor(np.asarray(st["rng"]).astype(np.int64))
    return out


def _setup(cfg_j, cfg_t, batch, frames, seed):
    voc = JSynthesizer(cfg_j, rng=jax.random.PRNGKey(seed))
    conds = voc.conditions(jnp.asarray(
        _features(np.random.RandomState(5), batch, frames)))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, voc.params),
                                       "cpu")
    tables = t_lpcnet.precompute_sample_tables(params, cfg_t)
    tconds = {k: torch.as_tensor(np.array(conds[k]))
              for k in ("cond_a", "cond_b", "lpc")}
    return voc, conds, voc.reset(batch, per_stream_rng=True), tables, tconds


@pytest.fixture(scope="module")
def narrow():
    voc, _, state, tables, tconds = _setup(
        j_lpcnet.LPCNetConfig(**NARROW), t_lpcnet.LPCNetConfig(**NARROW),
        3, 2, 3)
    cfg = t_lpcnet.LPCNetConfig(**NARROW)
    # a state warmed by a frame, so that no leaf is trivial
    warm, _ = t_scan.synthesize_frames(
        tables, _to_torch_state(state),
        {k: v[:, :1] for k, v in tconds.items()}, cfg)
    return tables, warm, {k: v[:, 1] for k, v in tconds.items()}, cfg


def _assert_same(got, ref):
    assert torch.equal(got[1], ref[1])
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k


@pytest.mark.parametrize("nsamples", [1, 2, 7, 160])
@pytest.mark.parametrize("pipeline_thr", [False, True], ids=["fuse", "opt"])
def test_plain_opt_bit_identical_to_base(narrow, pipeline_thr, nsamples):
    """Exact (pcm and every state leaf, the RNG included): the fused
    operands hold the same numbers and every sum keeps the walked-tree
    loop's order; nsamples 1 and 2 are all lookahead and rollback."""
    tables, state, cond, cfg = narrow
    ref = t_scan.synth_samples(tables, state, cond, cfg, nsamples)
    got = t_scan.synthesize_frame_opt(
        tables, state, cond["cond_a"], cond["cond_b"], cond["lpc"], cfg,
        pipeline_thr=pipeline_thr, nsamples=nsamples)
    assert got[1].shape == (3, nsamples)
    _assert_same(got, ref)


def test_fused_operands_are_the_tpu_kernels(narrow):
    """tbl_cat, dfc_w12 and the bias as synthesize_frame_pallas builds them
    (sample_pallas.py:1000-1008), built once per tables dict."""
    tables = narrow[0]
    fused = t_scan.fused_operands(tables)
    assert fused is t_scan.fused_operands(tables)
    dfc = tables["dual_fc"]
    assert fused["tbl_cat"].shape == (768, 3 * 96)
    for i, k in enumerate(("tbl_sig", "tbl_pred", "tbl_exc")):
        assert torch.equal(fused["tbl_cat"][256 * i:256 * (i + 1)], tables[k])
    assert fused["dfc_w12"].shape == (16, 512)
    assert torch.equal(fused["dfc_w12"][:, :256], dfc["w"][0])
    assert torch.equal(fused["dfc_w12"][:, 256:], dfc["w"][1])
    assert torch.equal(fused["dfc_b12"], dfc["b"].reshape(512))


@pytest.mark.parametrize("variant", ["fuse", "opt"])
def test_wrapper_on_cpu_runs_plain_opt(narrow, variant):
    """A CPU tensor takes the plain fused loop, frame by frame, and the
    kernel's launch count stays where it was; synth_samples has no fused
    variant."""
    tables, state, cond, cfg = narrow
    conds = {k: torch.stack([v, v], dim=1) for k, v in cond.items()}
    before = dict(sample_cuda.launches)
    got = sample_cuda.synthesize_frames(tables, state, conds, cfg,
                                        variant=variant)
    assert sample_cuda.launches == before
    assert got[1].shape == (3, 320)
    _assert_same(got, t_scan.synthesize_frames(tables, state, conds, cfg))
    with pytest.raises(ValueError, match="variant"):
        sample_cuda.synth_samples(tables, state, cond, cfg, 80,
                                  variant=variant)


@pytest.fixture(scope="module")
def full():
    return _setup(CFG_J, CFG_T, 4, 2, 11)


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("variant", ["fuse", "opt"])
def test_plain_opt_matches_pallas_interpret(full, variant, batch):
    """Full width, T=2, per-stream RNG, against the JAX package's fused
    Pallas kernel in interpret mode: excitation and rng exact, GRU states
    to 1e-5, pcm equal but for rounding flips of floor(.5 + x) by 1 on at
    most 1% of the samples (the bound of test_torch_sample.py::
    test_synth_samples_matches_jax: the loops sum the LPC prediction and
    the GRU products in different orders, and the TPU loop adds cond_a
    after the three table rows; the sampled class never differs, so the
    streams do not drift). Run with -s for the measured values."""
    voc, conds, state, tables, tconds = full
    rows = lambda tree: {k: v[:batch] for k, v in tree.items()}
    st_p, pcm_p = sample_pallas.synthesize_frames_pallas(
        voc.tables, rows(state), rows(conds), CFG_J, interpret=True,
        variant=variant)
    st_t, pcm_t = t_scan.synthesize_frames_opt(
        tables, _to_torch_state(rows(state)), rows(tconds), CFG_T,
        pipeline_thr=variant == "opt")
    assert pcm_t.shape == (batch, 320)
    d = np.abs(pcm_t.numpy() - np.asarray(pcm_p))
    print(f"{variant} B={batch} vs pallas interpret: pcm max |d| {d.max()}, "
          f"exact {(d == 0).mean():.6f}")
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(),
                                                      (d == 0).mean())
    np.testing.assert_array_equal(st_t["last_exc"].numpy(),
                                  np.asarray(st_p["last_exc"]))
    np.testing.assert_array_equal(st_t["rng"].numpy(),
                                  np.asarray(st_p["rng"]).astype(np.int64))
    for k in ("gru_a", "gru_b"):
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_p[k]),
                                   atol=1e-5, err_msg=k)
