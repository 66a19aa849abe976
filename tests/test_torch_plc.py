"""The port's packet-loss-concealment engines (lpcnet_tpu_torch/plc.py)
against the JAX package's with backend="scan", at a narrow width that the
plain sample loop supports (GRU-A 96 = 2 slices of 48), and the engines'
behaviour (the port of tests/test_plc.py for the two engines)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import plc as j_engine
from lpcnet_tpu.constants import FRAME_SIZE, NB_FEATURES, PLC_MAX_FEC
from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.models import plc as j_plc
from lpcnet_tpu_torch import cli, convert
from lpcnet_tpu_torch import plc as t_engine
from lpcnet_tpu_torch.kernels import sample_cuda
from lpcnet_tpu_torch.models import lpcnet as t_lpcnet
from lpcnet_tpu_torch.models import plc as t_plc

HERE = os.path.dirname(__file__)
SPEECH = np.fromfile(os.path.join(HERE, "golden", "speech.s16"),
                     np.int16).astype(np.float32)
WIDTHS = dict(gru_a_units=96, cond_size=32)
PCFG_J = j_plc.PLCConfig(dense_size=32, gru_size=48)
PCFG_T = t_plc.PLCConfig(dense_size=32, gru_size=48)
OFF = 80
B, T = 2, 8
# stream 0: good, good, good, lost, lost, blend, good, good; stream 1 never
# loses
LOST = np.zeros((B, T), bool)
LOST[0, 3:5] = True
INT_LEAVES = {"causal": ("loss_count", "blend", "fec_fill", "fec_read",
                         "fec_keep", "fec_skip"),
              "noncausal": ("loss_count", "queued")}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain loops are thousands of small operations: more intra-op
    threads only spin and slow the other test workers down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speech(batch, frames, start=8000, hop=3000):
    return np.stack([SPEECH[start + i * hop:start + i * hop
                            + frames * FRAME_SIZE] for i in range(batch)])


def _engines(kind):
    """The JAX engine (scan backend) and the port's on the CPU, with the
    same random-init weights carried across."""
    look = 0 if kind == "noncausal" else 2
    cj = j_lpcnet.LPCNetConfig(lookahead=look, **WIDTHS)
    ct = t_lpcnet.LPCNetConfig(lookahead=look, **WIDTHS)
    lp = j_lpcnet.init_params(jax.random.PRNGKey(0), cj)
    pp = j_plc.init_params(jax.random.PRNGKey(1), PCFG_J)
    tlp = convert.params_from_numpy(jax.tree.map(np.asarray, lp), "cpu")
    tpp = convert.params_from_numpy(jax.tree.map(np.asarray, pp), "cpu")
    if kind == "noncausal":
        return (j_engine.NonCausalPLCEngine(lp, pp, cj, PCFG_J,
                                            backend="scan"),
                t_engine.NonCausalPLCEngine(tlp, tpp, ct, PCFG_T,
                                            device="cpu"))
    return (j_engine.PLCEngine(lp, pp, cj, PCFG_J, backend="scan"),
            t_engine.PLCEngine(tlp, tpp, ct, PCFG_T, device="cpu"))


@pytest.fixture(scope="module", params=["causal", "noncausal"])
def pair(request):
    return (request.param,) + _engines(request.param)


@pytest.fixture(scope="module")
def engine(pair):
    return pair[0], pair[2]


def _frames(pcm, t):
    return pcm[:, t * FRAME_SIZE:(t + 1) * FRAME_SIZE]


def test_engine_matches_jax(pair):
    """8 frames, B=2, per-stream loss flags. Every step: integer state
    exact, good rows equal to the JAX engine's and to the input (delayed by
    80 samples for the non-causal engine). Concealed and blended frames of
    the lossy stream: exact fraction >= 0.90 and correlation >= 0.99 (the
    class of lpcnet_tpu/verify.py:198-202)."""
    kind, je, te = pair
    pcm = _speech(B, T)
    sj, st = je.init_state(B), te.init_state(B)
    before = dict(sample_cuda.launches)
    outs_j, outs_t = [], []
    for t in range(T):
        sj, oj = je.step(sj, jnp.asarray(_frames(pcm, t)),
                         jnp.asarray(LOST[:, t]))
        st, ot = te.step(st, _frames(pcm, t), LOST[:, t])
        for k in INT_LEAVES[kind]:
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                          err_msg=f"{k} frame {t}")
        outs_j.append(np.asarray(oj))
        outs_t.append(ot.numpy())
    assert sample_cuda.launches == before       # CPU: plain versions only
    oj, ot = np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)
    assert ot.shape == (B, T * FRAME_SIZE) and np.isfinite(ot).all()
    delay = OFF if kind == "noncausal" else 0
    # the stream that never loses passes through, exactly
    np.testing.assert_array_equal(ot[1, delay:],
                                  pcm[1, :T * FRAME_SIZE - delay])
    np.testing.assert_array_equal(ot[1], oj[1])
    # the lossy stream: good frames before the loss pass through exactly
    np.testing.assert_array_equal(ot[0, delay:3 * FRAME_SIZE],
                                  pcm[0, :3 * FRAME_SIZE - delay])
    # concealed (3, 4) and blended (5) frames, and the frame after
    lo, hi = 3 * FRAME_SIZE, 7 * FRAME_SIZE
    exact = float((ot[0, lo:hi] == oj[0, lo:hi]).mean())
    corr = float(np.corrcoef(ot[0, lo:hi], oj[0, lo:hi])[0, 1])
    print(f"{kind}: concealed+blended frames exact {exact:.6f} corr "
          f"{corr:.8f}")
    assert np.abs(ot[0, lo:lo + 2 * FRAME_SIZE]).max() > 0
    assert exact >= 0.90 and corr >= 0.99, (exact, corr)
    # recovered: the last frame passes through again
    np.testing.assert_array_equal(ot[0, 7 * FRAME_SIZE + delay:],
                                  pcm[0, 7 * FRAME_SIZE:T * FRAME_SIZE
                                      - delay])
    assert int(st["loss_count"].max()) == 0


def test_all_good_passthrough(engine):
    kind, te = engine
    pcm = _speech(B, 4, start=20000)
    st = te.init_state(B)
    outs = []
    for t in range(4):
        st, out = te.step(st, _frames(pcm, t), np.zeros(B, bool))
        outs.append(out.numpy())
    got = np.concatenate(outs, 1)
    if kind == "noncausal":
        np.testing.assert_array_equal(got[:, OFF:], pcm[:, :-OFF])
        np.testing.assert_array_equal(got[:, :OFF], 0.0)
    else:
        np.testing.assert_array_equal(got, pcm)


def test_per_stream_independence(engine):
    """A loss on stream 0 leaves stream 1's output what it is without it."""
    kind, te = engine
    pcm = _speech(B, 5, start=24000)
    delay = OFF if kind == "noncausal" else 0
    st = te.init_state(B)
    for t in range(5):
        st, out = te.step(st, _frames(pcm, t), [t == 2, False])
        if t >= 1:
            lo = t * FRAME_SIZE - delay
            np.testing.assert_array_equal(out[1].numpy(),
                                          pcm[1, lo:lo + FRAME_SIZE])


def test_run_equals_a_loop_of_step(engine):
    _, te = engine
    rs = np.random.RandomState(11)
    frames = 4
    pcm = (rs.randn(B, frames * FRAME_SIZE) * 2000).astype(np.float32)
    lost = rs.uniform(size=(B, frames)) < 0.4
    s1 = te.init_state(B)
    outs = []
    for t in range(frames):
        s1, o = te.step(s1, _frames(pcm, t), lost[:, t])
        outs.append(o)
    s2, out = te.run(te.init_state(B), pcm, lost)
    assert torch.equal(out, torch.cat(outs, 1))
    assert torch.equal(s1["synth"]["rng"], s2["synth"]["rng"])
    assert torch.equal(s1["loss_count"], s2["loss_count"])


def test_requires_no_lookahead():
    ct = t_lpcnet.LPCNetConfig(**WIDTHS)
    lp = convert.params_from_numpy(jax.tree.map(
        np.asarray, j_lpcnet.init_params(jax.random.PRNGKey(0),
                                         j_lpcnet.LPCNetConfig(**WIDTHS))),
        "cpu")
    pp = convert.params_from_numpy(jax.tree.map(
        np.asarray, j_plc.init_params(jax.random.PRNGKey(1), PCFG_J)), "cpu")
    with pytest.raises(ValueError, match="lookahead"):
        t_engine.NonCausalPLCEngine(lp, pp, ct, PCFG_T, device="cpu")


@pytest.fixture(scope="module")
def causal_pair():
    return _engines("causal")


def test_fec_queue_matches_jax(causal_pair):
    """fec_add, three good frames (each discards one queued frame), a lost
    frame that consumes one, fec_clear: queue state equal to the JAX
    engine's at every point."""
    je, te = causal_pair
    rs = np.random.RandomState(5)
    sj, st = je.init_state(B), te.init_state(B)

    def same():
        for k in ("fec_fill", "fec_read", "fec_keep", "fec_skip",
                  "loss_count"):
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(st["fec"].numpy(),
                                      np.asarray(sj["fec"]))

    for i in range(6):
        feats = rs.randn(B, NB_FEATURES).astype(np.float32)
        mask = np.array([True, i % 2 == 0])
        sj = je.fec_add(sj, jnp.asarray(feats), jnp.asarray(mask))
        st = te.fec_add(st, feats, mask)
        same()
    assert st["fec_fill"].tolist() == [6, 3]
    pcm = _speech(B, 1)
    for lost in ([False, False], [False, False], [False, False],
                 [True, False], [True, True]):
        sj, _ = je.step(sj, jnp.asarray(pcm), jnp.asarray(lost))
        st, _ = te.step(st, pcm, lost)
        same()
    assert int(st["fec_read"][0]) >= 4
    sj, st = je.fec_clear(sj), te.fec_clear(st)
    same()
    assert int(st["fec_fill"].max()) == 0


def test_fec_add_compacts_a_full_queue(causal_pair):
    """Filling the queue past PLC_MAX_FEC shifts the window [keep, fill) to
    the origin (lpcnet_plc.c:111-132), as the JAX engine does."""
    je, te = causal_pair
    rs = np.random.RandomState(6)
    sj, st = je.init_state(1), te.init_state(1)
    keep = np.array([40], np.int32)
    sj = {**sj, "fec_keep": jnp.asarray(keep), "fec_read": jnp.asarray(keep)}
    st = {**st, "fec_keep": torch.as_tensor(keep),
          "fec_read": torch.as_tensor(keep)}
    for _ in range(PLC_MAX_FEC + 3):
        feats = rs.randn(1, NB_FEATURES).astype(np.float32)
        sj = je.fec_add(sj, jnp.asarray(feats))
        st = te.fec_add(st, feats)
    for k in ("fec_fill", "fec_read", "fec_keep"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(st["fec"].numpy(), np.asarray(sj["fec"]))
    assert int(st["fec_fill"][0]) == PLC_MAX_FEC - 40 + 3
    assert int(st["fec_keep"][0]) == 0


@pytest.mark.parametrize("kind", ["causal", "noncausal"])
def test_remove_dc_matches_jax(kind):
    """The DC-removal option (off by default): 5 frames with one loss on a
    signal with an offset; good rows to 1e-3 of the JAX engine's (the
    follower's 160-step recurrences round alike), integer state exact."""
    look = 0 if kind == "noncausal" else 2
    je, te = _engines(kind)
    opts_j = j_engine.PLCOptions(remove_dc=True)
    opts_t = t_engine.PLCOptions(remove_dc=True)
    je = type(je)(je.params, je.plc_params, je.cfg, PCFG_J, options=opts_j,
                  backend="scan")
    te = type(te)(te.params, te.plc_params, te.cfg, PCFG_T, options=opts_t,
                  device="cpu")
    assert te.cfg.lookahead == look
    pcm = _speech(B, 5, start=14000) + 300.0
    sj, st = je.init_state(B), te.init_state(B)
    for t in range(5):
        lost = [t == 2, False]
        sj, oj = je.step(sj, jnp.asarray(_frames(pcm, t)), jnp.asarray(lost))
        st, ot = te.step(st, _frames(pcm, t), lost)
        np.testing.assert_array_equal(st["loss_count"].numpy(),
                                      np.asarray(sj["loss_count"]))
        np.testing.assert_allclose(ot[1].numpy(), np.asarray(oj[1]),
                                   atol=1e-3, err_msg=f"frame {t}")
        for k in ("dc_mem", "syn_dc"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       atol=1e-2, err_msg=f"{k} frame {t}")
        assert np.isfinite(ot.numpy()).all()


def test_default_device_is_the_card(monkeypatch):
    """No device means CUDA; without CUDA that is an error, never a quiet
    move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lp, pp = convert.load_lpcnet(device="cpu"), convert.load_plc(device="cpu")
    for cls in (t_engine.PLCEngine, t_engine.NonCausalPLCEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(lp, pp)


def test_cli_plc_on_cpu(tmp_path, capsys):
    """`plc` over 6 frames, default (causal) mode, shipped weights at full
    width: good packets pass through, the lost packet is concealed with
    audio; an unknown mode is refused; the default device is the card (the
    strict mode's run is in tests/test_torch_strict.py)."""
    pcm = SPEECH[16000:16000 + 6 * FRAME_SIZE].astype(np.int16)
    pcm.tofile(tmp_path / "in.pcm")
    (tmp_path / "loss.txt").write_text("0\n1\n0\n")
    args = ["plc", str(tmp_path / "loss.txt"), str(tmp_path / "in.pcm"),
            str(tmp_path / "out.pcm")]
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = np.fromfile(tmp_path / "out.pcm", np.int16)
    assert out.shape == pcm.shape
    np.testing.assert_array_equal(out[:2 * FRAME_SIZE], pcm[:2 * FRAME_SIZE])
    np.testing.assert_array_equal(out[5 * FRAME_SIZE:], pcm[5 * FRAME_SIZE:])
    assert np.abs(out[2 * FRAME_SIZE:4 * FRAME_SIZE]).max() > 0
    with pytest.raises(SystemExit):
        cli.main(args + ["--device", "cpu", "--options", "strictest"])
    assert "invalid choice" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)
