"""The port's StrictCausalPLCEngine (lpcnet_tpu_torch/plc.py) against the
JAX package's with backend="scan": its helpers one by one, and the engine
at a narrow width that the plain sample loop supports (GRU-A 96 = 2 slices
of 48), B=2, 8 frames with good, lost and blend steps, without and with FEC
frames queued; and the CLI's strict mode at full width."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import plc as j_engine
from lpcnet_tpu.constants import FRAME_SIZE, NB_FEATURES
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
B, T = 2, 8
# stream 0: good, good, good, lost, lost, blend, good, good; stream 1 never
# loses
LOST = np.zeros((B, T), bool)
LOST[0, 3:5] = True
INT_LEAVES = ("loss_count", "blend", "feat_fill", "pcm_fill",
              "skip_analysis", "fec_fill", "fec_read", "fec_keep", "fec_skip")


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


def _frames(pcm, t):
    return pcm[:, t * FRAME_SIZE:(t + 1) * FRAME_SIZE]


def _tt(tree):
    """A JAX tree as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    a = np.array(tree)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _assert_tree(got, ref, atol=0.0, what=""):
    if isinstance(ref, dict):
        for k in ref:
            _assert_tree(got[k], ref[k], atol, f"{what}/{k}")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """The JAX engine (scan backend) and the port's on the CPU, with the
    same random-init weights carried across."""
    cj = j_lpcnet.LPCNetConfig(**WIDTHS)
    ct = t_lpcnet.LPCNetConfig(**WIDTHS)
    lp = j_lpcnet.init_params(jax.random.PRNGKey(0), cj)
    pp = j_plc.init_params(jax.random.PRNGKey(1), PCFG_J)
    tlp = convert.params_from_numpy(jax.tree.map(np.asarray, lp), "cpu")
    tpp = convert.params_from_numpy(jax.tree.map(np.asarray, pp), "cpu")
    return (j_engine.StrictCausalPLCEngine(lp, pp, cj, PCFG_J,
                                           backend="scan"),
            t_engine.StrictCausalPLCEngine(tlp, tpp, ct, PCFG_T,
                                           device="cpu"))


def test_init_state_matches_jax(pair):
    je, te = pair
    sj, st = je.init_state(B), te.init_state(B)
    assert te.buf_size == je.buf_size == 400
    assert set(st) == set(sj)
    for k in sj:
        if k not in ("synth", "enc"):
            _assert_tree(st[k], sj[k], what=k)
    assert st["pcm_buf"].shape == (B, 560)
    assert st["pcm_fill"].tolist() == [400, 400]


def test_feat_push_matches_jax(pair):
    """Six pushes under a per-stream mask: the 4-deep buffer fills and then
    drops its oldest entry. Exact (copies only)."""
    je, te = pair
    rs = np.random.RandomState(1)
    buf_j = jnp.zeros((B, 4, NB_FEATURES))
    fill_j = jnp.zeros((B,), jnp.int32)
    buf_t, fill_t = _tt(buf_j), _tt(fill_j)
    for i in range(6):
        feats = rs.randn(B, NB_FEATURES).astype(np.float32)
        mask = np.array([True, i % 3 != 1])
        buf_j, fill_j = je._feat_push(buf_j, fill_j, jnp.asarray(feats),
                                      jnp.asarray(mask))
        buf_t, fill_t = te._feat_push(buf_t, fill_t, torch.as_tensor(feats),
                                      torch.as_tensor(mask))
        _assert_tree(buf_t, buf_j, what=f"buf {i}")
        _assert_tree(fill_t, fill_j, what=f"fill {i}")
    assert fill_t.tolist() == [4, 4]


def test_push_copy_matches_jax(pair):
    je, te = pair
    rs = np.random.RandomState(2)
    sj = je.init_state(B)
    cur = {k: jnp.asarray(rs.randn(*v.shape).astype(np.float32))
           for k, v in sj["plc_net"].items()}
    mask = np.array([True, False])
    got = te._push_copy(_tt(sj["plc_copies"]), _tt(cur),
                        torch.as_tensor(mask))
    ref = je._push_copy(sj["plc_copies"], cur, jnp.asarray(mask))
    _assert_tree(got, ref)
    for k in cur:
        assert torch.equal(got[k][0, 0], _tt(cur[k])[0])
        assert not got[k][1].any()


def test_fnet_masked_matches_jax(pair):
    """Three steps: masked streams keep state and conditions, exactly; the
    others get frame_net_step's, to 1e-5 (matmuls summed in another
    order)."""
    je, te = pair
    rs = np.random.RandomState(3)
    sj = je.init_state(B)
    mask = np.array([True, False])
    fj, cj = sj["fnet"], sj["last_cond"]
    ft, ct = _tt(fj), _tt(cj)
    for _ in range(3):      # past the warm-up frames, whose conds are zero
        feats = rs.randn(B, NB_FEATURES).astype(np.float32) * 0.3
        fj, cj = je._fnet_masked(fj, cj, jnp.asarray(feats),
                                 jnp.asarray(mask))
        ft, ct = te._fnet_masked(ft, ct, torch.as_tensor(feats),
                                 torch.as_tensor(mask))
        _assert_tree(ft, fj, atol=1e-5)
        _assert_tree(ct, cj, atol=1e-5)
    assert ft["frame_count"].tolist() == [3, 0]
    assert not ct["cond_a"][1].any() and ct["cond_a"][0].any()


def test_get_fec_or_pred_matches_jax(pair):
    """Stream 0 has a FEC frame queued and is active, stream 1 has none:
    features and PLC-net state to 1e-5, the queue's integers exact."""
    je, te = pair
    rs = np.random.RandomState(4)
    sj = je.init_state(B)
    sj = je.fec_add(sj, jnp.asarray(rs.randn(B, NB_FEATURES).astype(
        np.float32)), jnp.asarray([True, False]))
    sj["fec_skip"] = jnp.asarray([0, 2], jnp.int32)
    keys = ("fec", "fec_fill", "fec_read", "fec_keep", "fec_skip")
    fec_j = {k: sj[k] for k in keys}
    prev = rs.randn(B, NB_FEATURES).astype(np.float32)
    for active in ([True, True], [False, True]):
        oj, pj, nj, tj = je._get_fec_or_pred(
            sj["plc_net"], fec_j, jnp.asarray(active), jnp.asarray(prev))
        ot, pt, nt, tk = te._get_fec_or_pred(
            _tt(sj["plc_net"]), _tt(fec_j), torch.as_tensor(active),
            torch.as_tensor(prev))
        _assert_tree(ot, oj, atol=1e-5)
        _assert_tree(pt, pj, atol=1e-5)
        for k in keys:
            _assert_tree(nt[k], nj[k], what=k)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(tj))
    assert tk.tolist() == [False, False] and nt["fec_skip"].tolist() == [0, 1]


def test_remove_dc_is_refused(pair):
    te = pair[1]
    with pytest.raises(ValueError, match="DC"):
        t_engine.StrictCausalPLCEngine(
            te.params, te.plc_params, te.cfg, PCFG_T,
            options=t_engine.PLCOptions(remove_dc=True), device="cpu")


def test_default_device_is_the_card(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    te = pair[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_engine.StrictCausalPLCEngine(te.params, te.plc_params, te.cfg,
                                       PCFG_T)


@pytest.mark.parametrize("fec", [False, True], ids=["no_fec", "fec_queued"])
def test_engine_matches_jax(pair, fec):
    """8 frames, B=2, per-stream loss flags; with `fec`, eight FEC frames
    are queued on stream 0 before the run, so the good frames discard
    three, the catch-up passes and the conceal steps consume the rest.
    Every step: integer state exact and good non-blend rows equal to their
    input. Concealed and blended frames of the lossy stream: exact fraction
    >= 0.90 and correlation >= 0.99 (the class of
    lpcnet_tpu/verify.py:198-202; the sample loops sum in different
    orders). Run with -s for the measured values."""
    je, te = pair
    pcm = _speech(B, T)
    sj, st = je.init_state(B), te.init_state(B)
    if fec:
        rs = np.random.RandomState(8)
        for _ in range(8):
            feats = rs.randn(B, NB_FEATURES).astype(np.float32) * 0.3
            sj = je.fec_add(sj, jnp.asarray(feats),
                            jnp.asarray([True, False]))
            st = te.fec_add(st, feats, [True, False])
    before = dict(sample_cuda.launches)
    outs_j, outs_t = [], []
    for t in range(T):
        sj, oj = je.step(sj, jnp.asarray(_frames(pcm, t)),
                         jnp.asarray(LOST[:, t]))
        st, ot = te.step(st, _frames(pcm, t), LOST[:, t])
        for k in INT_LEAVES:
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                          err_msg=f"{k} frame {t}")
        _assert_int_synth(st["synth"], sj["synth"], t)
        outs_j.append(np.asarray(oj))
        outs_t.append(ot.numpy())
    assert sample_cuda.launches == before       # CPU: plain versions only
    oj, ot = np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)
    assert ot.shape == (B, T * FRAME_SIZE) and np.isfinite(ot).all()
    # the stream that never loses, and the lossy one's good frames, pass
    # through exactly; the blend frame (5) does in its second half
    np.testing.assert_array_equal(ot[1], pcm[1])
    np.testing.assert_array_equal(ot[0, :3 * FRAME_SIZE],
                                  pcm[0, :3 * FRAME_SIZE])
    np.testing.assert_array_equal(ot[0, 6 * FRAME_SIZE:],
                                  pcm[0, 6 * FRAME_SIZE:])
    np.testing.assert_array_equal(ot[0, 5 * FRAME_SIZE + 80:6 * FRAME_SIZE],
                                  pcm[0, 5 * FRAME_SIZE + 80:6 * FRAME_SIZE])
    # concealed (3, 4) and blended (5) frames
    lo, hi = 3 * FRAME_SIZE, 6 * FRAME_SIZE
    exact = float((ot[0, lo:hi] == oj[0, lo:hi]).mean())
    corr = float(np.corrcoef(ot[0, lo:hi], oj[0, lo:hi])[0, 1])
    print(f"strict {'with' if fec else 'without'} FEC: concealed+blended "
          f"frames exact {exact:.6f} corr {corr:.8f}")
    assert np.abs(ot[0, lo:lo + 2 * FRAME_SIZE]).max() > 0
    assert exact >= 0.90 and corr >= 0.99, (exact, corr)
    assert int(st["loss_count"].max()) == 0
    if fec:
        assert int(st["fec_read"][0]) > 3


def _assert_int_synth(st_t, st_j, t):
    """The sample state's integers: the RNG, which advances only on active
    steps, and the excitation, the class sampled or forced last."""
    np.testing.assert_array_equal(
        st_t["rng"].numpy(), np.asarray(st_j["rng"]).astype(np.int64),
        err_msg=f"rng frame {t}")
    np.testing.assert_array_equal(
        st_t["last_exc"].numpy(), np.asarray(st_j["last_exc"]),
        err_msg=f"last_exc frame {t}")


def test_run_equals_a_loop_of_step(pair):
    te = pair[1]
    rs = np.random.RandomState(11)
    frames = 3
    pcm = (rs.randn(B, frames * FRAME_SIZE) * 2000).astype(np.float32)
    lost = np.array([[False, True, False], [True, False, False]])
    s1 = te.init_state(B)
    outs = []
    for t in range(frames):
        s1, o = te.step(s1, _frames(pcm, t), lost[:, t])
        outs.append(o)
    s2, out = te.run(te.init_state(B), pcm, lost)
    assert torch.equal(out, torch.cat(outs, 1))
    assert torch.equal(s1["synth"]["rng"], s2["synth"]["rng"])
    assert torch.equal(s1["pcm_fill"], s2["pcm_fill"])


def test_cli_plc_strict_on_cpu(tmp_path):
    """`plc --options strict` over 4 frames, shipped weights at full width:
    the good packet passes through, the lost packet is concealed with
    audio."""
    pcm = SPEECH[16000:16000 + 4 * FRAME_SIZE].astype(np.int16)
    pcm.tofile(tmp_path / "in.pcm")
    (tmp_path / "loss.txt").write_text("0\n1\n")
    assert cli.main(["plc", str(tmp_path / "loss.txt"),
                     str(tmp_path / "in.pcm"), str(tmp_path / "out.pcm"),
                     "--options", "strict", "--device", "cpu"]) == 0
    out = np.fromfile(tmp_path / "out.pcm", np.int16)
    assert out.shape == pcm.shape
    np.testing.assert_array_equal(out[:2 * FRAME_SIZE], pcm[:2 * FRAME_SIZE])
    assert np.abs(out[2 * FRAME_SIZE:]).max() > 0
