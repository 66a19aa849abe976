"""The CUDA frame kernel against its plain PyTorch version, on the card.

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "base"])
@pytest.mark.parametrize("batch", [1, 13])
def test_kernel_bit_identical_to_plain(card, variant, batch):
    """Same state, conditions and shipped weights: the kernel sums in the
    plain version's order, so pcm and the whole state agree exactly; a
    ragged last tile (13 streams) included."""
    voc = Synthesizer(device=card, variant=variant)
    f = np.stack([FEATS[5 * i:5 * i + 2] for i in range(batch)])
    conds = voc.conditions(f)
    state = voc.reset(batch, per_stream_rng=True)
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
