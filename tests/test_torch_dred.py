"""The port's DRED (lpcnet_tpu_torch: models/rdovae.py, dred.py,
utils/fec_packets.py, utils/import_torch.py, convert.load_dred) against
the JAX package's on the same inputs and weights: seeded numpy arrays, a
small random geometry (cond 32/16) and the shipped cond-256 weights
(examples/speech_dred_params.bin).

Measured on the CPU (port against JAX), max |d|: latents / states
4.8e-7 / 3.0e-7 (small geometry) and 1.9e-6 / 8.7e-7 (shipped weights,
40 frames); features decoded from the same latents and state 3.6e-7 and
5.7e-6. On the golden speech: latents 1.9e-6, PVQ states and vectors
exact, payload symbols equal on 100% of them, features decoded from the
same payload 8.6e-6; the port's q0 round-trip RMS 0.173.
Symbols are round(dead_zone(z*scale)): a float sum in another order can
flip one at a rounding tie, so the gate is a fraction (>= 99.5% equal,
all within 1), never a looser feature tolerance.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import cli as j_cli
from lpcnet_tpu import dred as j_dred
from lpcnet_tpu.data import _feature_step_fn
from lpcnet_tpu.features import init_state as j_feat_state
from lpcnet_tpu.models import rdovae as j_rv
from lpcnet_tpu.utils import fec_packets as j_fec
from lpcnet_tpu.utils import import_torch as j_imp
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch import dred as t_dred
from lpcnet_tpu_torch import features as t_feat
from lpcnet_tpu_torch.models import rdovae as t_rv
from lpcnet_tpu_torch.utils import fec_packets as t_fec
from lpcnet_tpu_torch.utils import import_torch as t_imp

HERE = os.path.dirname(__file__)
FEATS = np.fromfile(os.path.join(HERE, "golden", "ref_feats.f32"),
                    np.float32).reshape(-1, 36)
SPEECH = np.fromfile(os.path.join(HERE, "golden", "speech.s16"),
                     np.int16).astype(np.float32)
SMALL = dict(cond_size=32, cond_size2=16)
TOL = 1e-4     # latents, states, decoded features: float sums reordered
GATE_SYMBOLS = 0.995


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _small_params():
    """JAX init_params at cond 32/16 with a random quant embedding (the
    init is all zeros), as numpy."""
    cfg = j_rv.RDOVAEConfig(**SMALL)
    p = _tree_np(j_rv.init_params(jax.random.PRNGKey(3), cfg))
    p["quant_embed"]["e"] = np.random.RandomState(4).uniform(
        -2, 2, p["quant_embed"]["e"].shape).astype(np.float32)
    return p, cfg, t_rv.RDOVAEConfig(**SMALL)


@pytest.fixture(scope="module")
def shipped():
    """(JAX params, JAX cfg, port params on the CPU, port cfg)."""
    jp, jcfg = j_cli.load_dred_model(None)
    tp, tcfg = convert.load_dred(None, device="cpu")
    return jp, jcfg, tp, tcfg


def _assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def _symbols_agree(got, want):
    """Fraction of equal symbols; every one within 1."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    frac = float((got == want).mean())
    assert frac >= GATE_SYMBOLS, frac
    return frac


@pytest.mark.parametrize("geometry", ["small", "shipped"])
def test_encode_decode_match_jax(geometry, shipped):
    """encode: latents and states within 1e-4; decode of the same latents
    and state: features within 1e-4."""
    if geometry == "small":
        pn, jcfg, tcfg = _small_params()
        jp, tp = pn, convert.params_from_numpy(pn, "cpu")
        feats = np.random.RandomState(0).randn(2, 16, 20).astype(np.float32)
    else:
        jp, jcfg, tp, tcfg = shipped
        feats = FEATS[None, :40, :20]
    jz, js = j_rv.encode(jp, jnp.asarray(feats), jcfg)
    tz, ts = t_rv.encode(tp, torch.as_tensor(feats), tcfg)
    assert tz.shape == jz.shape and ts.shape == js.shape
    _assert_close(tz, jz)
    _assert_close(ts, js)
    zd = np.asarray(jz)[:, 1::2]
    st = np.asarray(js)[:, 1]
    want = j_rv.decode(jp, jnp.asarray(zd), jnp.asarray(st), jcfg)
    got = t_rv.decode(tp, torch.as_tensor(zd), torch.as_tensor(st), tcfg)
    assert got.shape == want.shape == (feats.shape[0], 4 * zd.shape[1], 20)
    _assert_close(got, want)


def test_quantizer_pieces_match_jax():
    """quant_params for every level and apply_dead_zone within 1e-6 (the
    same functions of the same numbers, evaluated by two libraries);
    pvq_quantize exact."""
    pn, jcfg, tcfg = _small_params()
    tp = convert.params_from_numpy(pn, "cpu")
    qid = np.arange(jcfg.nb_quant, dtype=np.int32)
    jq = j_rv.quant_params(pn, jnp.asarray(qid), jcfg)
    tq = t_rv.quant_params(tp, torch.as_tensor(qid), tcfg)
    for k in ("scale", "dead_zone", "soft", "hard"):
        np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]),
                                   rtol=1e-6, atol=1e-7)
    rs = np.random.RandomState(1)
    x = rs.randn(16, 80).astype(np.float32) * 3
    np.testing.assert_allclose(
        t_rv.apply_dead_zone(torch.as_tensor(x), tq["dead_zone"]).numpy(),
        np.asarray(j_rv.apply_dead_zone(jnp.asarray(x), jq["dead_zone"])),
        rtol=1e-6, atol=1e-6)
    s = rs.randn(3, 50, 24).astype(np.float32)
    np.testing.assert_array_equal(
        t_rv.pvq_quantize(torch.as_tensor(s), 82).numpy(),
        np.asarray(j_rv.pvq_quantize(jnp.asarray(s), 82)))


@pytest.mark.parametrize("n,q0,q1", [(16, 3, 15), (8, 3, 15), (1, 3, 15),
                                     (5, 0, 15), (12, 15, 3)])
def test_quant_id_ramp_exact(n, q0, q1):
    jc = j_dred.DREDConfig(num_dframes=n, q0=q0, q1=q1)
    tc = t_dred.DREDConfig(num_dframes=n, q0=q0, q1=q1)
    got, want = t_dred.quant_id_ramp(tc), j_dred.quant_id_ramp(jc)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _speech_feats():
    """Superframe features of the golden speech (200 frames), computed by
    the JAX package's jitted step (the fec-encode command's), as numpy."""
    step = _feature_step_fn(False, "superframe")
    pcm = SPEECH[None, :200 * 160]
    out, st = [], j_feat_state(1)
    for t0 in range(0, 200, 40):
        st, f, _ = step(st, jnp.asarray(pcm[:, t0 * 160:(t0 + 40) * 160]))
        out.append(np.asarray(f))
    return np.concatenate(out, axis=1)[..., :20]


def test_codec_payloads_match_jax(shipped):
    """DREDCodec on the golden speech with the shipped weights: encode
    (latents within 1e-4, PVQ states within 1e-4), quantize_payload at
    every packet position (symbols >= 99.5% equal, all within 1; qid
    exact), decode of the JAX payload's symbols and state (1e-4)."""
    jp, jcfg, tp, tcfg = shipped
    feats = _speech_feats()
    jdc = j_dred.DREDCodec(jp, jcfg)
    tdc = t_dred.DREDCodec(tp, tcfg, device="cpu")
    jzd, jsd = jdc.encode(jnp.asarray(feats))
    tzd, tsd = tdc.encode(feats)
    _assert_close(tzd, jzd)
    _assert_close(tsd, jsd)
    n = tdc.dred.num_dframes
    syms_t, syms_j = [], []
    for s in range(n, tzd.shape[1] + 1, 4):
        jsym, jqid = jdc.quantize_payload(jzd[:, :s])
        tsym, tqid = tdc.quantize_payload(tzd[:, :s])
        assert tsym.dtype == torch.int32
        np.testing.assert_array_equal(tqid.numpy(), np.asarray(jqid))
        syms_t.append(tsym.numpy())
        syms_j.append(np.asarray(jsym))
        want = jdc.decode(jsym, jqid, jsd[:, s - n])
        got = tdc.decode(np.asarray(jsym), tqid,
                         np.asarray(jsd[:, s - n]))
        assert got.shape == (1, 4 * n, 20)
        _assert_close(got, want)
    _symbols_agree(np.stack(syms_t), np.stack(syms_j))


def test_fec_files_byte_identical(tmp_path):
    """The same packets give the same .fec bytes, and each reader reads
    the other's file back exactly."""
    rs = np.random.RandomState(5)
    packets = [rs.randn(64, 36).astype(np.float32) for _ in range(3)]
    rates = [0, 517, 32767]
    a, b = str(tmp_path / "t.fec"), str(tmp_path / "j.fec")
    t_fec.write_fec_packets(a, packets, rates)
    j_fec.write_fec_packets(b, packets, rates)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        got, got_rates = t_fec.read_fec_packets(path)
        want, want_rates = j_fec.read_fec_packets(path)
        assert got_rates == want_rates == rates
        for g, w, p in zip(got, want, packets):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)


def test_load_dred_shipped_bit_for_bit(shipped):
    """convert.load_dred(None) holds the JAX loader's arrays bit for bit
    and reads the geometry (256, 256)."""
    jp, jcfg, tp, tcfg = shipped
    assert (tcfg.cond_size, tcfg.cond_size2) == (256, 256)
    assert tcfg == t_rv.RDOVAEConfig(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    flat_j = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    flat_t = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k].numpy(),
                                      np.asarray(flat_j[k]))


def _reference_state_dict(cond=24, cond2=16, latents=12, nf=20, state=8,
                          levels=16):
    """A reference-torch RDO-VAE state_dict of random numbers under the
    names and torch layouts the importers read."""
    g = torch.Generator().manual_seed(7)
    sd = {}

    def dense(name, nin, nout):
        sd[f"{name}.weight"] = torch.randn(nout, nin, generator=g)
        sd[f"{name}.bias"] = torch.randn(nout, generator=g)

    def gru(name, nin, n):
        sd[f"{name}.weight_ih_l0"] = torch.randn(3 * n, nin, generator=g)
        sd[f"{name}.weight_hh_l0"] = torch.randn(3 * n, n, generator=g)
        sd[f"{name}.bias_ih_l0"] = torch.randn(3 * n, generator=g)
        sd[f"{name}.bias_hh_l0"] = torch.randn(3 * n, generator=g)

    concat = 3 * cond2 + 5 * cond
    e, d = "core_encoder.module.", "core_decoder.module."
    dense(e + "dense_1", 2 * nf, cond2)
    gru(e + "gru_1", cond2, cond)
    dense(e + "dense_2", cond, cond2)
    gru(e + "gru_2", cond2, cond)
    dense(e + "dense_3", cond, cond2)
    gru(e + "gru_3", cond2, cond)
    dense(e + "dense_4", cond, cond)
    dense(e + "dense_5", cond, cond)
    dense(e + "state_dense_1", concat, 128)
    dense(e + "state_dense_2", 128, state)
    sd[e + "conv1.weight"] = torch.randn(latents, concat, 4, generator=g)
    sd[e + "conv1.bias"] = torch.randn(latents, generator=g)
    dense(d + "dense_1", latents, cond2)
    gru(d + "gru_1", cond2, cond)
    dense(d + "dense_2", cond, cond2)
    gru(d + "gru_2", cond2, cond)
    dense(d + "dense_3", cond, cond2)
    gru(d + "gru_3", cond2, cond)
    dense(d + "dense_4", cond, cond)
    dense(d + "dense_5", cond, cond)
    dense(d + "output", concat, 4 * nf)
    for i in (1, 2, 3):
        dense(d + f"gru_{i}_init", state, cond)
    sd["statistical_model.quant_embedding.weight"] = torch.randn(
        levels, 6 * latents, generator=g)
    return sd, (nf, latents, levels, cond, cond2), {"state_dim": state}


def _write_exchange_dir(root, sd):
    """The wexchange numpy export of a state_dict."""
    npy = {"weight_ih_l0": "weight_ih_rzn", "weight_hh_l0": "weight_hh_rzn",
           "bias_ih_l0": "bias_ih_rzn", "bias_hh_l0": "bias_hh_rzn"}
    for mod, dirname in j_imp._EXCHANGE_NAMES.items():
        os.makedirs(os.path.join(root, dirname))
        for key, v in sd.items():
            if key.rsplit(".", 1)[0] != mod:
                continue
            tensor = key.rsplit(".", 1)[1]
            name = ("weight_oik" if mod.endswith("conv1")
                    and tensor == "weight" else npy.get(tensor, tensor))
            np.save(os.path.join(root, dirname, name + ".npy"), v.numpy())


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_importers_match_jax(tmp_path):
    """A small reference-torch checkpoint (.pth) and its wexchange
    directory: the port's importers give the JAX importers' trees and
    configs exactly, and load_dred dispatches to them."""
    sd, args, kwargs = _reference_state_dict()
    pth = str(tmp_path / "rdovae.pth")
    torch.save({"state_dict": sd, "model_args": args,
                "model_kwargs": kwargs}, pth)
    xdir = str(tmp_path / "exchange")
    _write_exchange_dir(xdir, sd)
    for path, t_fn, j_fn in (
            (pth, t_imp.import_rdovae_torch, j_imp.import_rdovae_torch),
            (xdir, t_imp.import_rdovae_numpy_dir,
             j_imp.import_rdovae_numpy_dir)):
        tree, cfg = t_fn(path)
        jtree, jcfg = j_fn(path)
        _assert_trees_equal(tree, jtree)
        assert dataclass_dict(cfg) == dataclass_dict(jcfg)
        params, cfg2 = convert.load_dred(path, device="cpu")
        assert cfg2 == cfg
        _assert_trees_equal(convert.params_to_numpy(params), tree)
    # the imported model runs, with the torch geometry
    feats = torch.as_tensor(np.random.RandomState(2).randn(1, 8, 20),
                            dtype=torch.float32)
    z, st = t_rv.encode(params, feats, cfg)
    out = t_rv.decode(params, z[:, 1::2], st[:, 1], cfg)
    assert out.shape == (1, 8, 20) and torch.isfinite(out).all()


def dataclass_dict(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_shipped_weights_quality():
    """The recipe of tests/test_rdovae.py::TestShippedDRED on the port:
    the q0 round trip of 160 frames of the golden speech's superframe
    features, RMS < 0.8 (the JAX package measures 0.303 on holdout)."""
    params, cfg = convert.load_dred(None, device="cpu")
    st = t_feat.init_state(1, torch.device("cpu"))
    _, feats, _ = t_feat.compute_features(
        st, torch.as_tensor(SPEECH[None, :160 * 160]))
    assert t_dred.roundtrip(params, cfg, feats[:, :160, :20])[0] < 0.8
