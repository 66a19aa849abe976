"""The port's vocoder end to end (Synthesizer, CLI) against the JAX
package's Synthesizer(backend="scan") on the shipped weights and the
reference features, and the port's device rules."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu.vocoder import Synthesizer as JSynthesizer
from lpcnet_tpu_torch import cli
from lpcnet_tpu_torch.kernels import sample_cuda
from lpcnet_tpu_torch.vocoder import Synthesizer

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
FEATS = np.fromfile(os.path.join(os.path.dirname(__file__), "golden",
                                 "ref_feats.f32"), np.float32).reshape(-1, 36)


@pytest.mark.parametrize("offsets", [
    [30, 90],
    # drawn once from a seed, not chosen for passing
    np.random.RandomState(0).randint(0, FEATS.shape[0] - 2, 4).tolist()],
    ids=["fixed", "seeded"])
def test_synthesizer_matches_jax_scan(offsets):
    """Features -> pcm through both packages' entry points, T=2, per-stream
    RNG, one stream per frame offset. Gate of lpcnet_tpu/verify.py: rng
    exact, pcm exact fraction >= 0.95, correlation >= 0.999 (conditioning
    and loop sums run in another order). The CPU path must not touch the
    kernel."""
    B = len(offsets)
    f = np.stack([FEATS[o:o + 2] for o in offsets])
    params = jax.tree.map(jnp.asarray, j_wio.load_params(os.path.join(
        REPO, "examples", "speech_lpcnet_params.bin")))
    jv = JSynthesizer(params=params, backend="scan")
    st_j, pcm_j = jv.synthesize(jv.reset(B, per_stream_rng=True),
                                jnp.asarray(f))
    before = dict(sample_cuda.launches)
    tv = Synthesizer(device="cpu")
    st_t, pcm_t = tv.synthesize(tv.reset(B, per_stream_rng=True), f)
    assert sample_cuda.launches == before
    pcm_t, pcm_j = pcm_t.numpy(), np.asarray(pcm_j)
    assert pcm_t.shape == pcm_j.shape == (B, 320)
    np.testing.assert_array_equal(st_t["rng"].numpy(),
                                  np.asarray(st_j["rng"]).astype(np.int64))
    exact = (pcm_t == pcm_j).mean()
    corr = np.corrcoef(pcm_t.ravel(), pcm_j.ravel())[0, 1]
    assert exact >= 0.95 and corr >= 0.999, (exact, corr)


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """No device means CUDA; without CUDA that is an error, never a quiet
    move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Synthesizer()
    FEATS[:2].tofile(tmp_path / "f.f32")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["synthesis", str(tmp_path / "f.f32"),
                  str(tmp_path / "o.pcm")])
    assert not (tmp_path / "o.pcm").exists()


def test_cli_synthesis_on_cpu(tmp_path):
    FEATS[40:42].tofile(tmp_path / "f.f32")
    rc = cli.main(["synthesis", str(tmp_path / "f.f32"),
                   str(tmp_path / "o.pcm"), "--device", "cpu"])
    assert rc == 0
    pcm = np.fromfile(tmp_path / "o.pcm", np.int16)
    assert pcm.shape == (320,) and np.abs(pcm).max() > 0


def test_cli_decode_on_cpu_matches_jax(tmp_path):
    """Two packets of the JAX encode of the golden speech through both
    decode commands (the port's with --device cpu, JAX's with its scan
    backend): 1280 samples held to the gate of
    test_synthesizer_matches_jax_scan, pcm exact fraction >= 0.95 and
    correlation >= 0.999."""
    from lpcnet_tpu import cli as j_cli
    src = tmp_path / "in.s16"
    np.fromfile(os.path.join(REPO, "tests", "golden", "speech.s16"),
                np.int16)[:640 * 2].tofile(src)
    assert j_cli.main(["encode", str(src), str(tmp_path / "p.bin")]) == 0
    assert j_cli.main(["decode", str(tmp_path / "p.bin"),
                       str(tmp_path / "jax.pcm"), "--backend", "scan"]) == 0
    assert cli.main(["decode", str(tmp_path / "p.bin"),
                     str(tmp_path / "port.pcm"), "--device", "cpu"]) == 0
    want = np.fromfile(tmp_path / "jax.pcm", np.int16).astype(np.float64)
    got = np.fromfile(tmp_path / "port.pcm", np.int16).astype(np.float64)
    assert got.shape == want.shape == (1280,)
    exact = (got == want).mean()
    corr = np.corrcoef(got, want)[0, 1]
    assert exact >= 0.95 and corr >= 0.999, (exact, corr)


@pytest.fixture(scope="module")
def bf16_setup():
    """Shipped weights, one frame of the reference features for two
    streams at frame 2 of their window (the conditioning's same-padded
    convs have both neighbours), per-stream RNG."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.kernels import sample_scan
    from lpcnet_tpu_torch.models import lpcnet as t_lpcnet
    tree = j_wio.load_params(os.path.join(REPO, "examples",
                                          "speech_lpcnet_params.bin"))
    jv = JSynthesizer(params=jax.tree.map(jnp.asarray, tree), backend="scan")
    conds = jv.conditions(jnp.asarray(np.stack([FEATS[30:33],
                                                FEATS[90:93]])))
    conds = {k: conds[k][:, 2:3] for k in ("cond_a", "cond_b", "lpc")}
    state = jv.reset(2, per_stream_rng=True)
    cfg = t_lpcnet.LPCNetConfig()
    tables = t_lpcnet.precompute_sample_tables(
        convert.params_from_numpy(tree, "cpu"), cfg)
    t_state = {k: torch.as_tensor(np.array(v)) for k, v in state.items()}
    t_state["rng"] = torch.as_tensor(np.asarray(state["rng"]).astype(
        np.int64))
    t_conds = {k: torch.as_tensor(np.array(v)) for k, v in conds.items()}
    return (jv, state, conds, sample_scan.bf16_tables(tables), tables,
            t_state, t_conds, cfg)


@pytest.mark.parametrize("variant", ["flat", "fuse"])
def test_bf16_plain_loop_matches_pallas_interpret(bf16_setup, variant):
    """The port's frame wrapper on bf16 tables (CPU: the plain loop on the
    rounded tables widened) against the JAX package's
    synthesize_frames_pallas(table_dtype=bfloat16, interpret=True), B=2,
    1 frame, with the bound of ROADMAP.md section 3.3: rng and last_exc
    exact, pcm within 1 on at most 1% of the samples, GRU states to 1e-5.
    The launch counts do not move."""
    from lpcnet_tpu.kernels import sample_pallas
    from lpcnet_tpu.models import lpcnet as j_lpcnet
    jv, state, conds, tb, _, t_state, t_conds, cfg = bf16_setup
    st_p, pcm_p = sample_pallas.synthesize_frames_pallas(
        jv.tables, state, conds, j_lpcnet.LPCNetConfig(), interpret=True,
        table_dtype=jnp.bfloat16, variant=variant)
    before = dict(sample_cuda.launches)
    st_t, pcm_t = sample_cuda.synthesize_frames(tb, t_state, t_conds, cfg,
                                                variant=variant)
    assert sample_cuda.launches == before
    d = np.abs(pcm_t.numpy() - np.asarray(pcm_p))
    print(f"bf16 {variant} vs pallas interpret: pcm max |d| {d.max()}, "
          f"exact {(d == 0).mean():.6f}")
    assert d.max() <= 1 and (d == 0).mean() >= 0.99
    np.testing.assert_array_equal(st_t["rng"].numpy(),
                                  np.asarray(st_p["rng"]).astype(np.int64))
    np.testing.assert_array_equal(st_t["last_exc"].numpy(),
                                  np.asarray(st_p["last_exc"]))
    for k in ("gru_a", "gru_b"):
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_p[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_bf16_tables_are_the_rounded_tables(bf16_setup):
    """bf16_tables rounds the three embedding tables to nearest even and
    keeps every other entry; the plain loop on them equals the loop on the
    rounded tables widened to float32, bit for bit, and differs from the
    loop on the float32 tables in the GRU state."""
    from lpcnet_tpu_torch.kernels import sample_scan
    _, _, _, tb, tables, t_state, t_conds, cfg = bf16_setup
    for k in sample_scan.TABLES:
        assert tb[k].dtype == torch.bfloat16 and tables[k].dtype == \
            torch.float32
        want = np.asarray(jnp.asarray(tables[k].numpy()).astype(
            jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(tb[k].float().numpy(), want)
    assert tb["wr_a"] is tables["wr_a"]
    wide = {k: v for k, v in tb.items() if not k.startswith("fused")}
    wide.update({k: tb[k].float() for k in sample_scan.TABLES})
    cond = {k: v[:, 0] for k, v in t_conds.items()}
    got = sample_scan.synth_samples(tb, t_state, cond, cfg, 40)
    ref = sample_scan.synth_samples(wide, t_state, cond, cfg, 40)
    f32 = sample_scan.synth_samples(tables, t_state, cond, cfg, 40)
    assert torch.equal(got[1], ref[1])
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
    assert not torch.equal(got[0]["gru_a"], f32[0]["gru_a"])


def test_synthesizer_bf16_tables_and_the_kernels_that_take_none(bf16_setup):
    """Synthesizer(tables="bf16") hands synthesize's frame kernel the
    rounded tables, once, and keeps float32 ones for every other mode;
    the K3 and K4 wrappers refuse bf16 tables on every device rather than
    cast them, and an unknown table type is refused."""
    from lpcnet_tpu_torch.kernels import sample_scan
    _, _, _, tb, _, t_state, t_conds, cfg = bf16_setup
    v = Synthesizer(device="cpu", tables="bf16")
    assert v.frame_tables["tbl_sig"].dtype == torch.bfloat16
    assert v.tables["tbl_sig"].dtype == torch.float32
    assert v.frame_tables["wr_a"] is v.tables["wr_a"]
    assert sample_scan.table_dtype(Synthesizer(
        device="cpu").frame_tables) == torch.float32
    with pytest.raises(ValueError, match="tables"):
        Synthesizer(device="cpu", tables="fp8")
    cond = {k: x[:, 0] for k, x in t_conds.items()}
    with pytest.raises(TypeError, match="float32"):
        sample_cuda.synth_samples(tb, t_state, cond, cfg, 8)
    with pytest.raises(TypeError, match="float32"):
        sample_cuda.teacher_advance(tb, t_state, cond, cfg,
                                    torch.zeros((2, 8)))
    fused = sample_scan.fused_operands(tb)
    assert fused["tbl_cat"].dtype == torch.bfloat16
    assert "fused_bf16" in tb and "fused" not in tb
