"""DREDCodec's streaming sender (init_state, step) on the CPU at a small
geometry (cond 32/16) on random weights that the plain reference
(lpcnet_tpu_torch/plain/rdovae_encode.py) draws, every bias nonzero and
a scale and dead zone of its own for every latent and level: against the
whole-history encode and quantize_payload, and against the reference; a
bias or a quantizer planted in the wrong place is seen.

Tolerances: the step computes the same float32 sums as encode, but in
products of other shapes (a dframe's 2 pairs, not the whole sequence; the
conv's four taps as one product with two of them carried from the call
before), which may sum in another order: at this width the latents and
the states before PVQ agree to ~1e-7, so 1e-5 is two orders of margin;
the plain reference runs pair by pair and sums the conv's taps one by
one, the same bound. PVQ states are unit vectors of integer pulses: equal
pulses give them within 1e-6 (the straight-through form's rounding), one
pulse moved changes an entry by 1/82 or more. Symbols are rounded: the
step's are compared exactly with quantize_payload's on the step's own
latents (the same operations on the same numbers).
"""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch.dred import DREDCodec, DREDConfig
from lpcnet_tpu_torch.models import rdovae as rv
from lpcnet_tpu_torch.plain import rdovae_encode as plain

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FEATS = np.fromfile(os.path.join(HERE, "golden", "ref_feats.f32"),
                    np.float32).reshape(-1, 36)[:, :20]
CFG = rv.RDOVAEConfig(cond_size=32, cond_size2=16)
DFRAMES = 20
TOL_LATENT = 1e-5
TOL_PVQ = 1e-6


@pytest.fixture(scope="module")
def codec():
    params = plain.draw_params(7, dataclasses.asdict(CFG))
    return DREDCodec(params, CFG, DREDConfig(), device="cpu")


def _feats(offsets):
    """(B, 4 x DFRAMES, 20): each stream the golden features from its
    offset, looped."""
    n = FEATS.shape[0]
    idx = (np.asarray(offsets)[:, None] + np.arange(4 * DFRAMES)) % n
    return torch.as_tensor(FEATS[idx])


def _stream(codec, feats, chunk):
    """The step over feats in chunks of `chunk` dframes (the last one
    shorter); each output joined along the dframe axis."""
    st = codec.init_state(feats.shape[0])
    outs = [codec.step(st, feats[:, 4 * d:4 * min(DFRAMES, d + chunk)])
            for d in range(0, DFRAMES, chunk)]
    return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}


def _close(got, want, tol):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_step_in_chunks_is_the_whole_history_encode(codec, chunk):
    feats = _feats([0, 57])
    out = _stream(codec, feats, chunk)
    zd, sd = codec.encode(feats)
    _close(out["latents"], zd, TOL_LATENT)
    _close(out["states"], sd, TOL_PVQ)
    zp, sp = plain.encode(codec.params, feats)
    _close(out["latents"], zp, TOL_LATENT)
    _close(out["states"], sp, TOL_PVQ)


@pytest.mark.parametrize("chunk", [1, 3])
def test_payload_is_quantize_payload_of_the_history(codec, chunk):
    feats = _feats([11, 140])
    out = _stream(codec, feats, chunk)
    n = codec.dred.num_dframes
    zd = out["latents"]
    for s in range(n, DFRAMES + 1):
        sym, _ = codec.quantize_payload(zd[:, :s])
        assert torch.equal(out["symbols"][:, s - 1], sym), s
        assert torch.equal(out["oldest_state"][:, s - 1],
                           out["states"][:, s - n]), s
    # before a stream's 16th dframe the payload's older entries are zeros
    early = out["symbols"][:, 2, 3:]
    assert not early.any()
    assert not out["oldest_state"][:, :n - 1].any()
    at = list(range(DFRAMES))
    sym_p, old_p = plain.payloads(codec.params, zd, out["states"], at)
    assert torch.equal(out["symbols"], sym_p)
    assert torch.equal(out["oldest_state"], old_p)
    assert out["symbols"].abs().max() > 0


def test_two_streams_in_a_batch_are_each_alone(codec):
    feats = _feats([5, 90])
    both = _stream(codec, feats, 2)
    for b in range(2):
        alone = _stream(codec, feats[b:b + 1], 2)
        _close(both["latents"][b:b + 1], alone["latents"], TOL_LATENT)
        _close(both["states"][b:b + 1], alone["states"], TOL_PVQ)
        assert torch.equal(both["symbols"][b:b + 1], alone["symbols"])


def test_the_drawn_weights_give_every_bias_and_quantizer_a_value():
    p = plain.draw_params(7, dataclasses.asdict(CFG))
    for layer in p["enc"].values():
        for name, v in layer.items():
            if name.startswith("b"):
                assert bool((v != 0).all()), name
    e = p["quant_embed"]["e"]
    # scale and dead-zone columns differ across latents and across levels
    nl = CFG.nb_latents
    for cols in (e[:, :nl], e[:, nl:2 * nl]):
        assert bool((cols.std(dim=0) > 0.1).all())
        assert bool((cols.std(dim=1) > 0.1).all())
    assert torch.equal(e, plain.draw_params(7, dataclasses.asdict(CFG))
                       ["quant_embed"]["e"])


def _without_recurrent_bias(params, gru, out):
    for i, g in enumerate(("gru2", "gru4", "gru6")):
        torch.matmul(gru[:, i], params["enc"][g]["wr"], out=out[i])


@pytest.mark.parametrize("fault", ["recurrent_bias", "conv_bias_in_carry",
                                   "dead_zone_shifted", "scale_shifted"])
def test_a_misplaced_bias_or_quantizer_is_seen(fault, monkeypatch):
    """Each fault moves the step's answers off the reference's by far more
    than the tolerances above."""
    params = plain.draw_params(7, dataclasses.asdict(CFG))
    codec = DREDCodec(params, CFG, DREDConfig(), device="cpu")
    if fault == "recurrent_bias":
        monkeypatch.setattr(rv, "recurrent_products", _without_recurrent_bias)
    elif fault == "conv_bias_in_carry":
        orig = rv.encode_heads

        def heads(p, taps, carry, pre, cfg):
            z, s, carry = orig(p, taps, carry, pre, cfg)
            return z, s, carry + p["enc"]["bits_conv"]["b"]
        monkeypatch.setattr(rv, "encode_heads", heads)
    else:
        attr = {"dead_zone_shifted": "_dead_zone",
                "scale_shifted": "_scale"}[fault]
        setattr(codec, attr, torch.roll(getattr(codec, attr), 1, dims=-1))
    feats = _feats([0, 57])
    out = _stream(codec, feats, 1)
    zp, sp = plain.encode(params, feats)
    sym, _ = plain.payloads(params, zp, sp, range(DFRAMES))
    latent_gap = float((out["latents"] - zp).abs().max())
    assert latent_gap > 100 * TOL_LATENT or not torch.equal(
        out["symbols"], sym)


def test_step_counts_dframes_and_payloads(codec):
    from lpcnet_tpu_torch.utils import profiling
    before = dict(profiling.counters)
    codec.step(codec.init_state(3), _feats([0, 1, 2])[:, :8])
    for name in ("dred.dframes", "dred.payloads"):
        assert profiling.counters[name] - before.get(name, 0) == 6


def test_both_copies_of_the_reference_are_one_file():
    """The benchmark's copy reads nothing of the program; the two stay
    the same text."""
    ours = os.path.join(ROOT, "lpcnet_tpu_torch", "plain", "rdovae_encode.py")
    bench = os.path.join(ROOT, "lpcbench", "reference", "rdovae_encode.py")
    with open(ours) as a, open(bench) as b:
        text = a.read()
        assert text == b.read()
    tops = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or ".").split(".")[0])
    assert tops <= {"contextlib", "typing", "torch"}, tops
