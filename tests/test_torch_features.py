"""The port's feature extractor (features.py, both modes), Burg analysis
(ops/burg.py), streaming frame network (models/lpcnet.frame_net_step) and
PLC network (models/plc.py) against the JAX package on the same inputs."""
import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import features as j_feat
from lpcnet_tpu.constants import FRAME_SIZE, NB_BANDS
from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.models import plc as j_plc
from lpcnet_tpu.ops import burg as j_burg
from lpcnet_tpu.ops import dsp as j_dsp
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch import features as t_feat
from lpcnet_tpu_torch.models import lpcnet as t_lpcnet
from lpcnet_tpu_torch.models import plc as t_plc
from lpcnet_tpu_torch.ops import burg as t_burg
from lpcnet_tpu_torch.ops import dsp as t_dsp

HERE = os.path.dirname(__file__)
REPO = os.path.join(HERE, os.pardir)
SPEECH = np.fromfile(os.path.join(HERE, "golden", "speech.s16"),
                     np.int16).astype(np.float32)
FEATS = np.fromfile(os.path.join(HERE, "golden", "ref_feats.f32"),
                    np.float32).reshape(-1, 36)


def _chunks(batch, frames, start=8000, hop=3000):
    return np.stack([SPEECH[start + i * hop:start + i * hop
                            + frames * FRAME_SIZE] for i in range(batch)])


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


SIGNAL_LEAVES = ("analysis_mem", "mem_preemph", "aligned_hist",
                 "pitch_filt", "exc_hist")


def _assert_state(t_state, j_state, scale):
    """Extractor state: the integer pitch decision exact; the Viterbi and
    cepstral leaves to 1e-4; leaves that hold signal samples (sums of 17
    products of samples up to `scale`) to 2e-6 of that scale."""
    j_state = _np(j_state)
    assert set(t_state) == set(j_state)
    np.testing.assert_array_equal(t_state["best_i"].numpy(),
                                  j_state["best_i"])
    for k, want in j_state.items():
        got = t_state[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_allclose(
            got, want, rtol=0, err_msg=k,
            atol=2e-6 * scale if k in SIGNAL_LEAVES else 1e-4)


@pytest.mark.parametrize("return_mid", [False, True])
def test_compute_features_single_matches_jax(return_mid):
    """6 frames of two speech streams. Cepstrum and LPC to 1e-4 (the FFT
    contract of the README is ~1e-5), the pitch feature and best_i exact,
    the correlation feature to 1e-5."""
    x = _chunks(2, 6)
    want = j_feat.compute_features(j_feat.init_state(2), jnp.asarray(x),
                                   mode="single", return_mid=return_mid)
    got = t_feat.compute_features(t_feat.init_state(2), torch.as_tensor(x),
                                  mode="single", return_mid=return_mid)
    assert len(got) == len(want) == (4 if return_mid else 3)
    fj, ft = np.asarray(want[1]), got[1].numpy()
    assert ft.shape == (2, 6, 36)
    np.testing.assert_allclose(ft[..., :NB_BANDS], fj[..., :NB_BANDS],
                               atol=1e-4)
    np.testing.assert_allclose(ft[..., 20:], fj[..., 20:], atol=1e-4)
    np.testing.assert_array_equal(ft[..., 18], fj[..., 18])
    np.testing.assert_allclose(ft[..., 19], fj[..., 19], atol=1e-5)
    _assert_state(got[0], want[0], np.abs(x).max())
    if return_mid:
        _assert_state(got[3], want[3], np.abs(x).max())


def test_mid_state_is_a_one_frame_calls_state():
    x = torch.as_tensor(_chunks(2, 3))
    st0 = t_feat.init_state(2)
    st0, _, _ = t_feat.compute_features(st0, x[:, :FRAME_SIZE],
                                        mode="single")            # warm
    rest = x[:, FRAME_SIZE:]
    _, feats, _, mid = t_feat.compute_features(st0, rest, mode="single",
                                               return_mid=True)
    one, f1, _ = t_feat.compute_features(st0, rest[:, :FRAME_SIZE],
                                         mode="single")
    for k in one:
        torch.testing.assert_close(mid[k], one[k], rtol=0, atol=1e-3,
                                   msg=k)
    assert torch.equal(mid["best_i"], one["best_i"])
    torch.testing.assert_close(feats[:, :1], f1, rtol=0, atol=1e-5)


SP_INT_FIELDS = ("best", "voiced", "corr_id", "main_pitch", "modulation")


@pytest.mark.parametrize("quantize_pitch", [False, True])
def test_compute_features_superframe_matches_jax(quantize_pitch):
    """The codec's mode on the first 64 frames of the speech and a copy
    shifted by 1000 samples (16 superframes each), both packages' defaults
    (mode="superframe"). Each superframe's integer pitch decision (best,
    voiced, corr_id, main_pitch, modulation) exact and its frame_corr to
    1e-6; cepstrum and LPC to 1e-4 (FFT and matmul sums in another order);
    the pitch and correlation features to 1e-5; the state as in the single
    mode, best_i exact."""
    x = np.stack([SPEECH[:64 * FRAME_SIZE],
                  SPEECH[1000:1000 + 64 * FRAME_SIZE]])
    sj, fj, spj = j_feat.compute_features(j_feat.init_state(2),
                                          jnp.asarray(x), quantize_pitch)
    st, ft, spt = t_feat.compute_features(t_feat.init_state(2),
                                          torch.as_tensor(x), quantize_pitch)
    fj, ft = np.asarray(fj), ft.numpy()
    assert ft.shape == (2, 64, 36) and len(spt) == len(spj) == 16
    np.testing.assert_allclose(ft[..., :NB_BANDS], fj[..., :NB_BANDS],
                               atol=1e-4)
    np.testing.assert_allclose(ft[..., 20:], fj[..., 20:], atol=1e-4)
    np.testing.assert_allclose(ft[..., 18:20], fj[..., 18:20], atol=1e-5)
    for g, (a, b) in enumerate(zip(spj, spt)):
        assert set(a) == set(b)
        for k in SP_INT_FIELDS:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                          err_msg=f"superframe {g} {k}")
        np.testing.assert_allclose(b["frame_corr"].numpy(),
                                   np.asarray(a["frame_corr"]), atol=1e-6)
    _assert_state(st, sj, np.abs(x).max())


def test_compute_features_has_the_jax_signature():
    """The same parameters, order and defaults as the JAX function, so a
    call written for one gets the same features from the other; a chunk
    of the codec's mode is whole superframes."""
    assert inspect.signature(t_feat.compute_features).parameters.keys() \
        == inspect.signature(j_feat.compute_features).parameters.keys()
    for name, p in inspect.signature(
            j_feat.compute_features).parameters.items():
        assert inspect.signature(t_feat.compute_features).parameters[
            name].default == p.default, name
    with pytest.raises(ValueError, match="superframe"):
        t_feat.compute_features(t_feat.init_state(1),
                                torch.zeros((1, 6 * FRAME_SIZE)))
    with pytest.raises(ValueError, match="return_mid"):
        t_feat.compute_features(t_feat.init_state(1),
                                torch.zeros((1, 4 * FRAME_SIZE)),
                                return_mid=True)


@pytest.mark.parametrize("fn", ["apply_window", "forward_transform",
                                "compute_band_energy", "dct", "preemphasis"])
def test_dsp_matches_jax(fn):
    rs = np.random.RandomState(4)
    if fn == "compute_band_energy":
        x = (rs.randn(3, 161) + 1j * rs.randn(3, 161)).astype(np.complex64)
    elif fn == "dct":
        x = rs.randn(3, 18).astype(np.float32)
    else:
        x = (rs.randn(3, 320) * 1000).astype(np.float32)
    args_j, args_t = (jnp.asarray(x),), (torch.as_tensor(x),)
    if fn == "preemphasis":
        mem = rs.randn(3).astype(np.float32)
        args_j += (jnp.asarray(mem),)
        args_t += (torch.as_tensor(mem),)
    want = getattr(j_dsp, fn)(*args_j)
    got = getattr(t_dsp, fn)(*args_t)
    if fn == "preemphasis":
        want, got = want[0], got[0]
    want = np.asarray(want)
    # 1e-6 of the result's scale: FFT and matmul sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_burg_cepstral_analysis_matches_jax():
    # 1e-3: the bound the JAX package states against the C
    x = _chunks(4, 1, start=12000, hop=2000)
    want = np.asarray(j_burg.burg_cepstral_analysis(jnp.asarray(x)))
    got = t_burg.burg_cepstral_analysis(torch.as_tensor(x)).numpy()
    assert got.shape == (4, 36)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_burg_cepstral_analysis_golden():
    """Against the reference C's burg_cepstral_analysis, with the
    tolerances of tests/test_burg.py."""
    d = np.fromfile(os.path.join(HERE, "golden", "burg.bin"), np.float32)
    d = d.reshape(-1, FRAME_SIZE + 2 * NB_BANDS)
    got = t_burg.burg_cepstral_analysis(
        torch.as_tensor(d[:, :FRAME_SIZE].copy())).numpy()
    np.testing.assert_allclose(got, d[:, FRAME_SIZE:], rtol=2e-3, atol=5e-3)


def test_burg_analysis_whitens_ar_signal():
    rs = np.random.RandomState(0)
    e = rs.randn(4000).astype(np.float32)
    x = np.zeros(4000, np.float32)
    for i in range(2, 4000):
        x[i] = 1.3 * x[i - 1] - 0.6 * x[i - 2] + e[i]
    a, nrg = t_burg.burg_analysis(torch.as_tensor(x[None, -79:]))
    ja, jnrg = j_burg.burg_analysis(jnp.asarray(x[None, -79:]))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose(nrg.numpy(), np.asarray(jnrg), rtol=1e-4)
    assert float(nrg[0]) < 0.5 * float((x[-79:] ** 2).sum())


@pytest.fixture(scope="module")
def lpcnet_params():
    tree = j_wio.load_params(os.path.join(REPO, "examples",
                                          "speech_lpcnet_params.bin"))
    return jax.tree.map(jnp.asarray, tree), convert.params_from_numpy(
        tree, "cpu")


@pytest.mark.parametrize("lookahead", [2, 0])
def test_frame_net_step_matches_jax(lpcnet_params, lookahead):
    """6 streaming steps on the reference features, shipped weights, full
    width; conditions and state to 1e-5 (float32 matmuls in another
    order)."""
    jp, tp = lpcnet_params
    cj = j_lpcnet.LPCNetConfig(lookahead=lookahead)
    ct = t_lpcnet.LPCNetConfig(lookahead=lookahead)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    jt = j_lpcnet.precompute_sample_tables(jp, cj)
    tt = t_lpcnet.precompute_sample_tables(tp, ct)
    sj = j_lpcnet.frame_net_init_state(2, cj)
    st = t_lpcnet.frame_net_init_state(2, ct)
    assert st["old_lpc"].shape == (2, lookahead, 16)
    f = np.stack([FEATS[10:16], FEATS[100:106]])
    for t in range(6):
        sj, cond_j = j_lpcnet.frame_net_step(jp, jt, sj, jnp.asarray(f[:, t]),
                                             cj)
        st, cond_t = t_lpcnet.frame_net_step(tp, tt, st,
                                             torch.as_tensor(f[:, t]), ct)
        for k in ("cond_a", "cond_b", "lpc", "cfeat"):
            np.testing.assert_allclose(cond_t[k].numpy(),
                                       np.asarray(cond_j[k]), atol=1e-5,
                                       err_msg=f"{k} frame {t}")
    for k, want in _np(sj).items():
        np.testing.assert_allclose(st[k].numpy(), want, atol=1e-5,
                                   err_msg=k)
    assert int(st["frame_count"][0]) == 6


def test_plc_net_step_matches_jax():
    """Shipped PLC weights, 4 steps; prediction and GRU states to 1e-5."""
    tree = j_wio.load_params(os.path.join(REPO, "examples",
                                          "speech_plc_params.bin"))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.load_plc(device="cpu")
    assert dataclasses.asdict(t_plc.PLCConfig()) \
        == dataclasses.asdict(j_plc.PLCConfig())
    rs = np.random.RandomState(3)
    xs = rs.randn(4, 3, t_plc.PLC_INPUT_SIZE).astype(np.float32)
    sj, st = j_plc.init_net_state(3), t_plc.init_net_state(3)
    for t in range(4):
        sj, oj = j_plc.step(jp, sj, jnp.asarray(xs[t]))
        st, ot = t_plc.step(tp, st, torch.as_tensor(xs[t]))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
        assert float(ot[:, 19].max()) <= 0.5
    for k, want in _np(sj).items():
        np.testing.assert_allclose(st[k].numpy(), want, atol=1e-5)
