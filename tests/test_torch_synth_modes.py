"""The port's other synthesis modes (Synthesizer.synthesize_teacher,
synthesize_temperature, reset_streaming / synthesize_streaming, and the
fused frame variants) against the JAX package's Synthesizer(backend="scan")
on the shipped weights and the reference features, the CLI's modes, and
the control flow of verify.verify_on_device on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu.vocoder import Synthesizer as JSynthesizer
from lpcnet_tpu_torch import cli, verify
from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
from lpcnet_tpu_torch.training.losses import tree_to_pdf
from lpcnet_tpu_torch.vocoder import Synthesizer

HERE = os.path.dirname(__file__)
FEATS = np.fromfile(os.path.join(HERE, "golden", "ref_feats.f32"),
                    np.float32).reshape(-1, 36)
SPEECH = np.fromfile(os.path.join(HERE, "golden", "speech.s16"),
                     np.int16).astype(np.float32)
B = 2
OFFSETS = (30, 90)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain loops are thousands of small operations: more intra-op
    threads only spin and slow the other test workers down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(jnp.asarray, j_wio.load_params(os.path.join(
        HERE, os.pardir, "examples", "speech_lpcnet_params.bin")))
    return JSynthesizer(params=params, backend="scan"), \
        Synthesizer(device="cpu")


def _feats(frames):
    return np.stack([FEATS[o:o + frames] for o in OFFSETS])


def _assert_int_state(st_t, st_j):
    np.testing.assert_array_equal(st_t["rng"].numpy(),
                                  np.asarray(st_j["rng"]).astype(np.int64))
    np.testing.assert_array_equal(st_t["last_exc"].numpy(),
                                  np.asarray(st_j["last_exc"]))


def _assert_pcm_within_one(pcm_t, pcm_j, what):
    """pcm equal but for rounding flips of floor(.5 + x) by 1 on at most 1%
    of the samples: the two packages sum the prediction and the GRU
    products in different orders."""
    d = np.abs(pcm_t.numpy() - np.asarray(pcm_j))
    print(f"{what}: pcm max |d| {d.max()}, exact {(d == 0).mean():.6f}")
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(),
                                                      (d == 0).mean())


def test_synthesize_teacher_matches_jax(pair):
    """T=2, per-frame preload counts from none to the whole frame: rng and
    excitation exact, pcm within 1 on <= 1% of the samples, forced samples
    equal to the target; the port's entry point equals its plain
    synthesize_frames(target=, preload=) bit for bit and launches nothing
    on the CPU."""
    jv, tv = pair
    f = _feats(2)
    target = np.stack([SPEECH[8000 + 3000 * i:8000 + 3000 * i + 320]
                       for i in range(B)])
    preload = np.array([[160, 40], [0, 97]], np.int32)
    st_j, pcm_j = jv.synthesize_teacher(
        jv.reset(B, per_stream_rng=True), jnp.asarray(f),
        jnp.asarray(target), jnp.asarray(preload))
    before = dict(sample_cuda.launches)
    st0 = tv.reset(B, per_stream_rng=True)
    st_t, pcm_t = tv.synthesize_teacher(st0, f, target, preload)
    assert sample_cuda.launches == before
    assert pcm_t.shape == (B, 320)
    _assert_int_state(st_t, st_j)
    _assert_pcm_within_one(pcm_t, pcm_j, "teacher")
    for b in range(B):
        for t in range(2):
            n = preload[b, t]
            np.testing.assert_array_equal(
                pcm_t[b, t * 160:t * 160 + n].numpy(),
                target[b, t * 160:t * 160 + n])
    st_p, pcm_p = sample_scan.synthesize_frames(
        tv.tables, st0, tv.conditions(f), tv.cfg,
        target=torch.as_tensor(target), preload=torch.as_tensor(preload))
    assert torch.equal(pcm_p, pcm_t)
    for k in st_p:
        assert torch.equal(st_p[k], st_t[k]), k
    with pytest.raises(ValueError, match="preload"):
        tv.synthesize_teacher(st0, f, target, preload[:, :1])


def test_synthesize_temperature_matches_jax(pair):
    """T=2: one KISS99 draw per sample, so the rng is exact whatever is
    sampled; the excitation is exact as long as no inverse-CDF comparison
    lies within float rounding of the uniform draw (pow and cumsum round
    differently in the two packages), and then pcm is within 1 on <= 1% of
    the samples. Measured on these inputs: exact."""
    jv, tv = pair
    f = _feats(2)
    st_j, pcm_j = jv.synthesize_temperature(
        jv.reset(B, per_stream_rng=True), jnp.asarray(f))
    st_t, pcm_t = tv.synthesize_temperature(
        tv.reset(B, per_stream_rng=True), f)
    assert pcm_t.shape == (B, 320)
    _assert_int_state(st_t, st_j)
    _assert_pcm_within_one(pcm_t, pcm_j, "temperature")
    # not the tree sampler's output: the mode really took the other sampler
    _, pcm_tree = tv.synthesize(tv.reset(B, per_stream_rng=True), f)
    assert not torch.equal(pcm_tree, pcm_t)


def test_tree_to_pdf_is_a_pdf_and_matches_jax():
    from lpcnet_tpu.training.losses import tree_to_pdf as j_tree_to_pdf
    p = np.random.RandomState(2).uniform(0.02, 0.98, (3, 256)).astype(
        np.float32)
    pdf = tree_to_pdf(torch.as_tensor(p)).numpy()
    # 1e-6: eight float32 products per leaf, in the same order
    np.testing.assert_allclose(pdf, np.asarray(j_tree_to_pdf(jnp.asarray(p))),
                               rtol=1e-6)
    np.testing.assert_allclose(pdf.sum(-1), 1.0, atol=1e-5)
    # leaf 255 takes the 1-branch at every level: nodes 1, 3, 7, ..., 255
    np.testing.assert_allclose(
        pdf[:, 255], np.prod(p[:, [1, 3, 7, 15, 31, 63, 127, 255]], axis=-1),
        rtol=1e-5)


def test_synthesize_streaming_matches_jax(pair):
    """T=4 in two calls of 2 frames (the state carries the delay lines):
    the first `lookahead` frames are silence and leave the sample state
    and the RNG untouched; after them rng and excitation exact, pcm within
    1 on <= 1% of the samples."""
    jv, tv = pair
    f = _feats(4)
    sj, st = jv.reset_streaming(B, True), tv.reset_streaming(B, True)
    fresh = tv.reset(B, per_stream_rng=True)
    before = dict(sample_cuda.launches)
    outs_j, outs_t = [], []
    for t0 in (0, 2):
        sj, oj = jv.synthesize_streaming(sj, jnp.asarray(f[:, t0:t0 + 2]))
        st, ot = tv.synthesize_streaming(st, f[:, t0:t0 + 2])
        if t0 == 0:
            assert tv.cfg.lookahead == 2 and not ot.any()
            for k in fresh:
                assert torch.equal(st["synth"][k], fresh[k]), k
        np.testing.assert_array_equal(
            st["fnet"]["frame_count"].numpy(),
            np.asarray(sj["fnet"]["frame_count"]))
        outs_j.append(np.asarray(oj))
        outs_t.append(ot)
    assert sample_cuda.launches == before
    pcm_j, pcm_t = np.concatenate(outs_j, 1), torch.cat(outs_t, 1)
    assert pcm_t.shape == (B, 640) and pcm_t[:, 320:].abs().max() > 0
    _assert_int_state(st["synth"], sj["synth"])
    _assert_pcm_within_one(pcm_t, pcm_j, "streaming")


@pytest.mark.parametrize("variant", ["fuse", "opt"])
def test_synthesizer_fused_variants_same_bits(pair, variant):
    """Synthesizer(variant='fuse'|'opt') on the CPU: the plain fused loop,
    bit-identical to the default variant (pcm and every state leaf)."""
    tv = pair[1]
    f = _feats(1)
    st_r, pcm_r = tv.synthesize(tv.reset(B, per_stream_rng=True), f)
    fv = Synthesizer(params=tv.params, device="cpu", variant=variant)
    st_f, pcm_f = fv.synthesize(fv.reset(B, per_stream_rng=True), f)
    assert torch.equal(pcm_f, pcm_r)
    for k in st_r:
        assert torch.equal(st_f[k], st_r[k]), k
    with pytest.raises(ValueError, match="variant"):
        Synthesizer(params=tv.params, device="cpu", variant="fast")


def test_cli_synthesis_modes_on_cpu(tmp_path, capsys):
    """--streaming writes lookahead frames of silence and then audio,
    --temperature writes audio, and the two together are refused as in the
    JAX package's CLI."""
    FEATS[40:43].tofile(tmp_path / "f.f32")
    args = ["synthesis", str(tmp_path / "f.f32"), str(tmp_path / "o.pcm"),
            "--device", "cpu"]
    assert cli.main(args + ["--streaming"]) == 0
    pcm = np.fromfile(tmp_path / "o.pcm", np.int16)
    assert pcm.shape == (480,) and not pcm[:320].any() and pcm[320:].any()
    FEATS[40:41].tofile(tmp_path / "f.f32")
    assert cli.main(args + ["--temperature"]) == 0
    pcm = np.fromfile(tmp_path / "o.pcm", np.int16)
    assert pcm.shape == (160,) and np.abs(pcm).max() > 0
    assert cli.main(args + ["--temperature", "--streaming"]) == 1
    assert "--temperature" in capsys.readouterr().err


def test_verify_on_device_gates_on_cpu():
    """On the CPU both sides of every gate are the plain versions, so this
    holds the control flow only: the JAX package's gate names (but its
    interpret gates) and the two of the fused variants, all passing, a
    strict run with good, lost and blend steps, and no kernel launch. On a
    card chip_smoke.py runs the same function through the kernels."""
    before = dict(sample_cuda.launches)
    report = verify.verify_on_device(batch=2, frames=1, plc_batch=3,
                                     plc_frames=2, device="cpu")
    assert sample_cuda.launches == before
    gates = {k for k, g in report.items() if isinstance(g, dict) and "ok" in g}
    # lpcnet_tpu/verify.py's gates without flat_rng_exact_vs_interpret and
    # flat_vs_interpret, and the two of the fused variants
    assert gates == {
        "flat_rng_exact", "flat_vs_scan", "base_rng_exact", "base_vs_scan",
        "teacher_forced_pcm_exact", "teacher_forced_exc_exact",
        "teacher_forced_rng_exact", "teacher_forced_gru_tol",
        "force_from_rng_exact", "force_from_vs_scan",
        "teacher_advance_state_exact", "teacher_advance_gru_tol",
        "strict_plc_step", "fuse_vs_base_exact", "opt_vs_base_exact"}
    assert report["ok"] and all(report[g]["ok"] for g in gates)
    sp = report["strict_plc_step"]["measured"]
    assert sp["exact_frac"] == 1.0
    assert sp["lost_steps"] and sp["blend_steps"] and sp["good_steps"]
