"""The port's evaluations and artifact fits (lpcnet_tpu_torch/tools/)
against the repo's JAX-driven tools/ scripts on the same inputs and the
shipped weights, on the CPU.

Tolerances, each the one measured (port on the CPU against the JAX tool
on the CPU here; chip_smoke.py holds the card against the port's CPU run
with the same ones), with a margin:
  - eval_lpcnet.synth_stats, the first 12 frames of the golden speech at
    B=1 (JAX's scan backend): pitch-lag autocorrelation 1e-5 (measured
    2.8e-8 here and 3.3e-7 card against CPU), log-spectral correlation
    5e-4 (3.0e-5; 2.5e-6), RMS 1e-5 relative (1.3e-6; 5.2e-7). The free
    runs differ by a few samples rounded the other way at float
    near-ties (ROADMAP.md §3.3), which sit elsewhere on every host: the
    statistics agree, the samples need not;
  - eval_plc's trained L1 on lost frames 1e-5;
  - eval_dred's rms and bits at two levels 1e-4 relative to the JAX tool's
    JSON, whose rounding (4 and 1 decimals) is allowed on top;
  - train_codebooks.stage_rms and codec_rms of the shipped codebooks
    1e-5;
  - fit_pade: the seed's max and mean |error| 2.5e-7 (measured 1.19e-7:
    XLA's float32 tanh and torch's differ by up to 2.4e-7), and after 20
    steps per stage the coefficients 1e-5 relative (5.0e-6) and the max
    and mean |error| 2e-3 relative (8.3e-4, 5.0e-4: the max error sits
    where the two tanh differ).
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.models import plc as j_plc
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu_torch import cli as t_cli
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.models import lpcnet as t_lpcnet
from lpcnet_tpu_torch.tools import (eval_dred, eval_lpcnet, eval_plc,
                                    fit_pade, train_codebooks)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SPEECH = os.path.join(REPO, "tests", "golden", "speech.s16")
FEATS = os.path.join(REPO, "tests", "golden", "ref_feats.f32")
EXAMPLES = os.path.join(REPO, "examples")
CPU = torch.device("cpu")
PCM = np.fromfile(SPEECH, np.int16).astype(np.float32)


def _jax_tool(name: str):
    """tools/<name>.py as a module (its top level imports no JAX)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(mod, argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()
    return capsys.readouterr().out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Full-width step loops of small ops: intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_eval_lpcnet_synth_stats_match_jax_scan():
    n = 12
    feats = eval_lpcnet.speech_features(PCM, CPU)
    assert feats.shape == (1, 200, 36)
    f = feats[:, :n].numpy()
    tree = j_wio.load_params(os.path.join(EXAMPLES,
                                          "speech_lpcnet_params.bin"))
    got = eval_lpcnet.synth_stats(convert.params_from_numpy(tree, CPU),
                                  t_lpcnet.LPCNetConfig(),
                                  torch.as_tensor(f), PCM, n, CPU)
    want = _jax_tool("eval_lpcnet").synth_stats(
        jax.tree.map(jnp.asarray, tree), j_lpcnet.LPCNetConfig(),
        jnp.asarray(f), PCM, n, backend="scan")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    assert got[0] > 0.5          # periodic at the conditioned pitch


def test_eval_plc_matches_jax(tmp_path, monkeypatch, capsys):
    btest = str(tmp_path / "b.f32")
    assert t_cli.main(["dump-data", "btest", SPEECH, btest,
                       "--device", "cpu"]) in (0, None)
    capsys.readouterr()
    ckpt = os.path.join(EXAMPLES, "speech_plc_params.bin")
    out = _run_main(_jax_tool("eval_plc"), [ckpt, btest], monkeypatch,
                    capsys).splitlines()
    n_lost, T, r = eval_plc.evaluate(ckpt, btest, device=CPU)
    assert out[0] == f"lost frames: {n_lost}/{T} at rate 0.25"
    trained = float(out[1].split("trained ")[1].split()[0])
    zero = float(out[1].split("predict-zero ")[1].split()[0])
    assert abs(r["trained"] - trained) <= 5e-4         # printed to 3 places
    assert abs(r["predict-zero"] - zero) <= 5e-4
    # unrounded: the JAX net on the same masked inputs
    data = np.fromfile(btest, np.float32).reshape(-1, 72)
    inputs, feat, lost = eval_plc.masked_inputs(data, 0.25, 0)
    pred = np.asarray(j_plc.forward_sequence(
        jax.tree.map(jnp.asarray, j_wio.load_params(ckpt)),
        jnp.asarray(inputs), j_plc.PLCConfig())[0])
    np.testing.assert_allclose(
        r["trained"], np.abs(pred[lost] - feat[lost]).mean(), atol=1e-5)
    assert r["trained"] < 0.5 * min(r["predict-zero"], r["random init"])


def test_eval_dred_matches_jax(tmp_path, monkeypatch, capsys):
    ckpt = os.path.join(EXAMPLES, "speech_dred_params.bin")
    path = str(tmp_path / "jax.json")
    _run_main(_jax_tool("eval_dred"),
              [ckpt, path, "--source", f"speech={FEATS}", "--levels", "0",
               "15"], monkeypatch, capsys)
    with open(path) as f:
        want = json.load(f)
    got = eval_dred.evaluate(ckpt, [("speech", FEATS)], (0, 15),
                             device=CPU, verbose=False)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("cond_size", "cond_size2",
                                "holdout_frames")} == {
        k: want[k] for k in ("cond_size", "cond_size2", "holdout_frames")}
    g, w = got["sources"]["speech"], want["sources"]["speech"]
    assert g["frames"] == w["frames"] == 200
    assert set(g["levels"]) == set(w["levels"]) == {"0", "15", "rate_span"}
    for lv in ("0", "15"):
        a, b = g["levels"][lv], w["levels"][lv]
        assert set(a) == set(b)
        assert abs(a["rms"] - b["rms"]) <= 1e-4 * b["rms"] + 5e-5
        assert (abs(a["bits_per_dframe"] - b["bits_per_dframe"])
                <= 1e-4 * b["bits_per_dframe"] + 0.05)
        assert a["rms"] < 0.5 * a["rand_rms"]
    assert g["levels"]["rate_span"] == w["levels"]["rate_span"]


def test_train_codebooks_measures_match_jax():
    jt = _jax_tool("train_codebooks")
    path = os.path.join(EXAMPLES, "codec_codebooks.bin")
    cbs = {k: np.asarray(v) for k, v in t_cli.load_codebooks(
        path, CPU).items()}
    held = train_codebooks.build_corpus(PCM, 2, 100003, CPU)
    assert held.shape == (400, 36) and np.isfinite(held).all()
    got, want = train_codebooks.stage_rms(held, cbs, CPU), jt.stage_rms(
        held, cbs)
    assert set(got) == set(want) == {"stage1_rms", "stage2_rms",
                                     "stage3_rms"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    assert got["stage3_rms"] < got["stage2_rms"] < got["stage1_rms"]
    np.testing.assert_allclose(train_codebooks.codec_rms(PCM, cbs, CPU),
                               jt.codec_rms(PCM, cbs), rtol=0, atol=1e-5)


def test_fit_pade_matches_jax():
    jt = _jax_tool("fit_pade")
    x, y, basis = fit_pade.grid(CPU)
    err = (fit_pade.predict(fit_pade.seed_params(CPU), x, basis)
           - y).abs().numpy()
    want, wmax, wmean = jt.fit(0, verbose=False)
    assert want == {"num": [945.0, 105.0, 1.0], "den": [945.0, 420.0, 15.0]}
    np.testing.assert_allclose(err.max(), wmax, rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(err.mean(), wmean, rtol=0, atol=2.5e-7)
    got, gmax, gmean = fit_pade.fit(20, verbose=False, device=CPU)
    want, wmax, wmean = jt.fit(20, verbose=False)
    for k in ("num", "den"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    np.testing.assert_allclose(gmax, wmax, rtol=2e-3)
    np.testing.assert_allclose(gmean, wmean, rtol=2e-3)
    assert gmax < err.max()          # the fit improves on the seed
