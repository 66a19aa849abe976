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
