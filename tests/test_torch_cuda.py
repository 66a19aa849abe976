"""The CUDA sample kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips where torch finds no CUDA device. This file
imports neither jax nor lpcnet_tpu, so it also runs on a machine with the
card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
from lpcnet_tpu_torch.vocoder import Synthesizer

FEATS = np.fromfile(os.path.join(os.path.dirname(__file__), "golden",
                                 "ref_feats.f32"), np.float32).reshape(-1, 36)
# the argument sets the PLC engines pass to synth_samples: (nsamples,
# target, preload, force_from, n_active)
FLAG_SETS = {
    "free80": (80, False, False, False, False),
    "target": (160, True, False, False, False),
    "target_preload": (160, True, True, False, False),
    "target_force_from": (160, True, False, True, False),
    "target_force_from_n_active": (160, True, False, True, True),
    "n_active": (160, False, False, False, True),
    # the strict engine's three: catch-up over the delay buffer, the 80/80
    # split conceal and the blend continuation, the forced blend
    "strict_catchup": (160, True, True, False, True),
    "strict_free80": (80, False, False, False, True),
    "strict_blend80": (80, True, True, False, True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _setup(card, batch, variant="flat", warm=True):
    """Shipped weights, one frame of conditions per stream, and a state
    warmed by a frame of free-run synthesis so that no leaf is trivial."""
    voc = Synthesizer(device=card, variant=variant)
    f = np.stack([FEATS[5 * i:5 * i + 2] for i in range(batch)])
    conds = voc.conditions(f)
    state = voc.reset(batch, per_stream_rng=True)
    if warm:
        state, _ = sample_cuda.synthesize_frames(
            voc.tables, state, {k: conds[k][:, :1].contiguous()
                                for k in ("cond_a", "cond_b", "lpc")},
            voc.cfg, variant=variant)
    cond = {k: conds[k][:, 1].contiguous()
            for k in ("cond_a", "cond_b", "lpc")}
    return voc, conds, state, cond


def _flag_args(name, batch, device, seed=3):
    ns, has_target, has_pre, has_ff, has_act = FLAG_SETS[name]
    rs = np.random.RandomState(seed)
    i32 = dict(dtype=torch.int32, device=device)
    kw = {}
    if has_target:
        kw["target"] = torch.as_tensor(
            np.round(rs.randn(batch, ns) * 2500).astype(np.float32),
            device=device)
    if has_pre:
        kw["preload"] = torch.as_tensor(rs.randint(0, ns + 1, batch), **i32)
    if has_ff:
        kw["force_from"] = torch.as_tensor(rs.randint(40, ns + 1, batch),
                                           **i32)
    if has_act:
        kw["n_active"] = torch.as_tensor(rs.randint(0, ns + 1, batch), **i32)
    return ns, kw


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "base"])
@pytest.mark.parametrize("batch", [1, 13])
def test_kernel_bit_identical_to_plain(card, variant, batch):
    """Same state, conditions and shipped weights: the kernel sums in the
    plain version's order, so pcm and the whole state agree exactly; a
    ragged last tile (13 streams) included."""
    voc, conds, state, _ = _setup(card, batch, variant, warm=False)
    before = sample_cuda.launches[variant]
    st_k, pcm_k = sample_cuda.synthesize_frames(voc.tables, state, conds,
                                                voc.cfg, variant=variant)
    torch.cuda.synchronize()
    assert sample_cuda.launches[variant] == before + 2
    st_p, pcm_p = sample_scan.synthesize_frames(voc.tables, state, conds,
                                                voc.cfg,
                                                flat=variant == "flat")
    assert torch.equal(pcm_k, pcm_p)
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fuse", "opt"])
@pytest.mark.parametrize("batch", [1, 13])
def test_fused_kernel_bit_identical_to_plain_and_base(card, variant, batch):
    """K5 over 2 frames: pcm and every state leaf equal to its plain
    version's (synthesize_frames_opt) and to the walked-tree kernel's on
    the same inputs; a ragged last tile (13 streams) included."""
    voc, conds, state, _ = _setup(card, batch, "base", warm=False)
    conds = {k: conds[k].contiguous() for k in ("cond_a", "cond_b", "lpc")}
    before = dict(sample_cuda.launches)
    st_k, pcm_k = sample_cuda.synthesize_frames(voc.tables, state, conds,
                                                voc.cfg, variant=variant)
    torch.cuda.synchronize()
    after = dict(sample_cuda.launches)
    assert after.pop(variant) == before.pop(variant) + 2
    assert after == before
    st_p, pcm_p = sample_scan.synthesize_frames_opt(
        voc.tables, state, conds, voc.cfg, pipeline_thr=variant == "opt")
    st_b, pcm_b = sample_cuda.synthesize_frames(voc.tables, state, conds,
                                                voc.cfg, variant="base")
    assert pcm_k.shape == (batch, 320)
    assert torch.equal(pcm_k, pcm_p) and torch.equal(pcm_k, pcm_b)
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k
        assert torch.equal(st_k[k], st_b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "base"])
@pytest.mark.parametrize("batch", [1, 13])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_synth_samples_bit_identical_to_plain(card, flags, batch, variant):
    """K3 on every argument set the engines pass: one launch, and pcm and
    every state leaf equal to the plain loop's."""
    voc, _, state, cond = _setup(card, batch, variant)
    ns, kw = _flag_args(flags, batch, card)
    before = dict(sample_cuda.launches)
    st_k, pcm_k = sample_cuda.synth_samples(voc.tables, state, cond, voc.cfg,
                                            ns, variant=variant, **kw)
    torch.cuda.synchronize()
    after = dict(sample_cuda.launches)
    assert after.pop("tf_" + variant) == before.pop("tf_" + variant) + 1
    assert after == before
    st_p, pcm_p = sample_scan.synth_samples(voc.tables, state, cond, voc.cfg,
                                            ns, flat=variant == "flat", **kw)
    assert pcm_k.shape == (batch, ns)
    assert torch.equal(pcm_k, pcm_p)
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 13])
def test_teacher_advance_bit_identical_to_plain_and_forced_k3(card, batch):
    """K4 against its plain version and against a fully forced K3 launch:
    every state leaf equal."""
    voc, _, state, cond = _setup(card, batch)
    ns, kw = _flag_args("target", batch, card)
    before = sample_cuda.launches["teacher"]
    st_k, out = sample_cuda.teacher_advance(voc.tables, state, cond, voc.cfg,
                                            kw["target"])
    torch.cuda.synchronize()
    assert sample_cuda.launches["teacher"] == before + 1
    assert out is kw["target"]
    st_p, _ = sample_scan.teacher_advance(voc.tables, state, cond, voc.cfg,
                                          kw["target"])
    st_3, pcm_3 = sample_cuda.synth_samples(voc.tables, state, cond, voc.cfg,
                                            ns, target=kw["target"])
    assert torch.equal(pcm_3, kw["target"])
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k
        assert torch.equal(st_k[k], st_3[k]), k


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    voc, _, state, cond = _setup(card, 2, warm=False)
    with pytest.raises(TypeError):
        sample_cuda.synth_samples(
            voc.tables, state, cond, voc.cfg, 80,
            n_active=torch.zeros(2, dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        sample_cuda.synth_samples(
            voc.tables, state, cond, voc.cfg, 80,
            preload=torch.zeros(2, dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        sample_cuda.teacher_advance(
            voc.tables, state, cond, voc.cfg,
            torch.zeros((2, 0), device=card))
