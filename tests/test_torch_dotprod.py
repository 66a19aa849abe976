"""The port's DOT_PROD emulation (lpcnet_tpu_torch/kernels/sample_dotprod.py)
and Synthesizer(backend="dotprod") against the JAX package's
(lpcnet_tpu/kernels/sample_dotprod.py) with the shipped vocoder weights.

On the same tables and the same frame conditions the two are bit-identical
in both flavours: pcm, excitation, RNG and GRU states (B=2 x 2 frames of
tests/golden/ref_feats.f32, 640 samples). Through Synthesizer the
conditions are the port's own, which differ from JAX's by up to 1.8e-6
(frame network products summed in another order); the activation
quantizer floor(.5 + 127*h) turns such an ulp into a whole int8 step, so
the streams fork: measured 0.603 (signed) and 0.556 (SU) of the samples
equal over those 640, RNG exact (the draws do not depend on the samples).
That is the module's documented amplification, not a fault of the port,
so the Synthesizer test holds the port to its own conditions.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import sample_dotprod as j_dp
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu.vocoder import Synthesizer as JSynth
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.kernels import sample_dotprod as t_dp
from lpcnet_tpu_torch.ops import kiss99
from lpcnet_tpu_torch.vocoder import Synthesizer as TSynth

HERE = os.path.dirname(__file__)
FEATS = np.fromfile(os.path.join(HERE, "golden", "ref_feats.f32"),
                    np.float32).reshape(-1, 36)
PARAMS = j_wio.load_params(os.path.join(HERE, os.pardir, "examples",
                                        "speech_lpcnet_params.bin"))
KEYS = ("cond_a", "cond_b", "lpc")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The emulation is thousands of small operations per sample: more
    intra-op threads only spin and slow the other test workers down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synths():
    """{su: (JAX Synthesizer, port Synthesizer on the CPU)}, dotprod."""
    return {su: (JSynth(params=jax.tree.map(jnp.asarray, PARAMS),
                        backend="dotprod", dotprod_su=su),
                 TSynth(params=convert.params_from_numpy(PARAMS, "cpu"),
                        device="cpu", backend="dotprod", dotprod_su=su))
            for su in (False, True)}


def _feats(batch, frames):
    offs = 10 + 30 * np.arange(batch)
    return np.stack([FEATS[o:o + frames] for o in offs])


@pytest.mark.parametrize("su", [False, True])
def test_quantize_tables_exact(synths, su):
    js, ts = synths[su]
    assert ts.qtables["su"] == js.qtables["su"] == su
    for k in ("diag_a", "qr_a", "qi_b", "qr_b", "br_a", "bi_b_extra",
              "br_b"):
        want = np.asarray(js.qtables[k])
        got = ts.qtables[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k, g in ts.qtables["groups"].items():
        np.testing.assert_array_equal(
            g.numpy().reshape(-1, g.shape[-1]),
            np.asarray(js.qtables[k], np.float32))


@pytest.mark.parametrize("su", [False, True])
def test_synthesize_frames_dotprod_bit_identical_to_jax(synths, su):
    """B=2 x 2 frames on JAX's conditions: pcm, exc, rng and both GRU
    states exact."""
    js, ts = synths[su]
    conds = {k: np.asarray(v) for k, v in
             js.conditions(jnp.asarray(_feats(2, 2))).items() if k in KEYS}
    jst, jpcm = jax.jit(lambda s, c: j_dp.synthesize_frames_dotprod(
        js.tables, js.qtables, s, c, js.cfg))(
            js.reset(2, per_stream_rng=True),
            {k: jnp.asarray(v) for k, v in conds.items()})
    tst, tpcm = t_dp.synthesize_frames_dotprod(
        ts.tables, ts.qtables, ts.reset(2, per_stream_rng=True),
        {k: torch.as_tensor(v) for k, v in conds.items()}, ts.cfg)
    assert tpcm.shape == (2, 320)
    np.testing.assert_array_equal(tpcm.numpy(), np.asarray(jpcm))
    np.testing.assert_array_equal(tst["rng"].numpy(),
                                  np.asarray(jst["rng"]).astype(np.int64))
    for k in ("last_exc", "gru_a", "gru_b", "last_sig", "deemph"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)


def test_synth_samples_dotprod_teacher_bit_identical_to_jax(synths):
    """synth_samples_dotprod with a target and per-stream preload counts
    (80 samples): the forced samples equal the target, and the whole run
    JAX's bits."""
    js, ts = synths[False]
    conds = {k: np.asarray(v)[:, 0] for k, v in
             js.conditions(jnp.asarray(_feats(2, 1))).items() if k in KEYS}
    rs = np.random.RandomState(0)
    target = np.round(rs.randn(2, 80) * 300).astype(np.float32)
    preload = np.array([30, 80], np.int32)
    jst, jpcm = j_dp.synth_samples_dotprod(
        js.tables, js.qtables, js.reset(2),
        {k: jnp.asarray(v) for k, v in conds.items()}, js.cfg, 80,
        target=jnp.asarray(target), preload=jnp.asarray(preload))
    tst, tpcm = t_dp.synth_samples_dotprod(
        ts.tables, ts.qtables, ts.reset(2),
        {k: torch.as_tensor(v) for k, v in conds.items()}, ts.cfg, 80,
        target=torch.as_tensor(target), preload=torch.as_tensor(preload))
    np.testing.assert_array_equal(tpcm.numpy(), np.asarray(jpcm))
    np.testing.assert_array_equal(tpcm[0, :30].numpy(), target[0, :30])
    np.testing.assert_array_equal(tpcm[1].numpy(), target[1])
    np.testing.assert_array_equal(tst["gru_a"].numpy(),
                                  np.asarray(jst["gru_a"]))


@pytest.mark.parametrize("su", [False, True])
def test_synthesizer_dotprod_runs_the_emulation(synths, su):
    """Synthesizer(backend="dotprod"): synthesize (B=2 x 1 frame) is
    synthesize_frames_dotprod on the port's own conditions, bit for bit;
    synthesize_streaming (3 frames) gives silence over its warm-up frames,
    then int16-range audio. The RNG has made two draws per synthesized
    sample (kiss99_advance)."""
    _, ts = synths[su]
    feats = _feats(2, 1)
    st0 = ts.reset(2, per_stream_rng=True)
    st, pcm = ts.synthesize(st0, feats)
    conds = {k: v for k, v in ts.conditions(feats).items() if k in KEYS}
    st2, pcm2 = t_dp.synthesize_frames_dotprod(ts.tables, ts.qtables, st0,
                                               conds, ts.cfg)
    assert torch.equal(pcm, pcm2) and torch.equal(st["rng"], st2["rng"])
    assert torch.equal(st["rng"], kiss99.kiss99_advance(st0["rng"], 320))
    if su:
        return
    sst, spcm = ts.synthesize_streaming(ts.reset_streaming(2),
                                        _feats(2, 3))
    look = ts.cfg.lookahead
    assert spcm.shape == (2, 480) and not spcm[:, :look * 160].any()
    assert 0 < spcm[:, look * 160:].abs().max() <= 32767
    assert torch.equal(sst["synth"]["rng"], kiss99.kiss99_advance(
        ts.reset(2)["rng"], 2 * 160 * (3 - look)))


def test_synthesizer_refuses_unknown_backend():
    params = convert.params_from_numpy(PARAMS, "cpu")
    with pytest.raises(ValueError, match="backend"):
        TSynth(params=params, device="cpu", backend="scan")
    with pytest.raises(ValueError, match="float32 tables"):
        TSynth(params=params, device="cpu", backend="dotprod",
               tables="bf16")
    with pytest.raises(ValueError, match="dotprod_su"):
        TSynth(params=params, device="cpu", dotprod_su=True)


def test_mul_keeps_jax_overflow_value():
    """_mul is min(a*b, FLT_MAX), the JAX package's value on overflow; the
    strict activations equal the plain loop's on ordinary inputs."""
    big = torch.tensor([3e38, -3e38, 2.0])
    got = t_dp._mul(big, torch.tensor([10.0, 10.0, 3.0]))
    want = j_dp._mul(jnp.asarray(big.numpy()), jnp.asarray([10.0, 10.0,
                                                             3.0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.linspace(-9, 9, 2001).astype(np.float32)
    for t_fn, j_fn in ((t_dp._tanh_c, j_dp._tanh_c),
                       (t_dp._sigmoid_c, j_dp._sigmoid_c)):
        np.testing.assert_array_equal(t_fn(torch.as_tensor(x)).numpy(),
                                      np.asarray(j_fn(jnp.asarray(x))))
    pcm = np.linspace(-40000, 40000, 4001).astype(np.float32)
    np.testing.assert_array_equal(
        t_dp._lin2ulaw_c(torch.as_tensor(pcm)).numpy(),
        np.asarray(j_dp._lin2ulaw_c(jnp.asarray(pcm))))
