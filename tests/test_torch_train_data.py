"""The port's training data (lpcnet_tpu_torch/data.py, utils/native.py,
ops/dsp.deemphasis_scan and the dump-data command) against the JAX
package's on the golden speech (tests/golden/speech.s16, 200 frames).

Gates: augmentation identical (the same native library); the pair
builder exact, native and numpy loop, on JAX's features; features within
1e-4, as tests/test_torch_features.py holds them; the sig_out column
exact; sig_in equal on >= 0.99 of the samples. sig_in feeds the mu-law of
its own LPC prediction back (dump_data.c:84-108), so an LPC coefficient
1e-5 apart can flip one excitation step and the stream runs apart for a
few samples: measured equal on 0.99972 (seed 0, every sample within 1)
and 0.99134 (seed 3, 0.99506 within 1, max 8), with the RMS of the
difference 0.17% of the signal's; the pairs built from the same
features are bit-identical. window_batches exact for the same
RandomState.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import cli as j_cli
from lpcnet_tpu import data as j_data
from lpcnet_tpu.ops import dsp as j_dsp
from lpcnet_tpu.utils import native as j_native
from lpcnet_tpu_torch import cli as t_cli
from lpcnet_tpu_torch import data as t_data
from lpcnet_tpu_torch.ops import dsp as t_dsp
from lpcnet_tpu_torch.utils import native as t_native

HERE = os.path.dirname(__file__)
SPEECH_PATH = os.path.join(HERE, "golden", "speech.s16")
SPEECH = np.fromfile(SPEECH_PATH, np.int16).astype(np.float32)
FEAT_TOL = 1e-4
SIG_IN_EQUAL = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's recurrences are step loops of thousands of small ops;
    with several test workers on one host, intra-op threads only contend
    (a full-width step took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sig_in_agreement(dt, dj):
    d = np.abs(dt[:, 0].astype(np.int64) - dj[:, 0])
    rms = np.sqrt((d.astype(np.float64) ** 2).mean()
                  / (dj[:, 0].astype(np.float64) ** 2).mean())
    return float((d == 0).mean()), float((d <= 1).mean()), int(d.max()), rms


def test_native_library_loads():
    assert t_native.get_lib() is not None, t_native.NATIVE.how
    assert t_native.NATIVE.how in ("loaded", "built")


def test_augment_is_identical():
    xt, nt = t_data.augment(SPEECH, seed=5)
    xj, nj = j_data.augment(SPEECH, seed=5)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(nt, nj)


def test_deemphasis_scan_is_bit_identical():
    rs = np.random.RandomState(0)
    for n in (1, 7, 1001):
        e = (rs.randn(3, n) * 3000).astype(np.float32)
        m = (rs.randn(3) * 100).astype(np.float32)
        yt, mt = t_dsp.deemphasis_scan(torch.as_tensor(e), torch.as_tensor(m))
        yj, mj = j_dsp.deemphasis_scan(jnp.asarray(e), jnp.asarray(m))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.fixture(scope="module")
def jax_pass():
    """JAX's prepare_training_data of the golden speech at seeds 0 and 3."""
    return {s: j_data.prepare_training_data(SPEECH, seed=s) for s in (0, 3)}


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_build_pairs_exact_on_jax_features(jax_pass, native, monkeypatch):
    """On JAX's features and noise, the port's pair builder (the native
    library, or its numpy loop) equals JAX's (the native library, or its
    own loop) bit for bit."""
    fj, _ = jax_pass[0]
    x, noise = t_data.augment(SPEECH, seed=0)
    n = 12 * 160                        # the numpy loops: a short stretch
    pcm16 = t_data._delayed_pcm16(x[:len(fj) * 160])[:n]
    lpc, noise = fj[:12, 20:36], noise[:n]
    if not native:
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
    np.testing.assert_array_equal(t_data.build_pairs(pcm16, lpc, noise),
                                  j_data.build_pairs(pcm16, lpc, noise))


@pytest.mark.parametrize("seed", [0, 3])
def test_prepare_training_data_matches_jax(jax_pass, seed):
    fj, dj = jax_pass[seed]
    ft, dt = t_data.prepare_training_data(SPEECH, seed=seed, device="cpu")
    assert ft.shape == fj.shape and dt.shape == dj.shape
    np.testing.assert_allclose(ft, fj, rtol=0, atol=FEAT_TOL)
    np.testing.assert_array_equal(dt[:, 1], dj[:, 1])
    equal, within1, worst, rms = _sig_in_agreement(dt, dj)
    print(f"\nseed {seed}: features max |d| {np.abs(ft - fj).max():.3e}; "
          f"sig_in equal {equal:.6f}, within 1 {within1:.6f}, max |d| "
          f"{worst}, RMS of the difference {rms:.2e} of the signal's")
    assert equal >= SIG_IN_EQUAL


def test_prepare_training_data_batch_matches_jax():
    """Two passes as one batched feature stream (the --batch-passes path)."""
    ft, dt = t_data.prepare_training_data_batch(SPEECH[:96 * 160], [1, 2],
                                                device="cpu")
    fj, dj = j_data.prepare_training_data_batch(SPEECH[:96 * 160], [1, 2])
    np.testing.assert_allclose(ft, fj, rtol=0, atol=FEAT_TOL)
    np.testing.assert_array_equal(dt[:, 1], dj[:, 1])
    assert _sig_in_agreement(dt, dj)[0] >= SIG_IN_EQUAL


def test_window_batches_exact(jax_pass):
    fj, dj = jax_pass[0]
    kw = dict(batch_size=3, frames_per_chunk=5)
    got = list(t_data.window_batches(fj, dj, rng=np.random.RandomState(4),
                                     **kw))
    want = list(j_data.window_batches(fj, dj, rng=np.random.RandomState(4),
                                      **kw))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", ["btest", "train"])
def test_dump_data_matches_the_jax_command(mode, tmp_path):
    """dump-data --device cpu against the JAX command on the same input:
    the same frame count and width; features within FEAT_TOL (btest's
    second half is the test mode's features; its Burg cepstra within
    1e-3: the Burg recursion sums in another order); train's data with
    sig_out exact and sig_in as above."""
    args = ["dump-data", mode, SPEECH_PATH]
    outs = {}
    for name, main in (("t", t_cli.main), ("j", j_cli.main)):
        f, d = str(tmp_path / f"{name}.f32"), str(tmp_path / f"{name}.s16")
        extra = ["--device", "cpu"] if name == "t" else []
        assert main(args + [f] + ([d] if mode == "train" else []) + extra) \
            in (0, None)
        outs[name] = (f, d)
    width = 72 if mode == "btest" else 36
    ft = np.fromfile(outs["t"][0], np.float32).reshape(-1, width)
    fj = np.fromfile(outs["j"][0], np.float32).reshape(-1, width)
    assert ft.shape == fj.shape == (200, width)
    burg = 36 if mode == "btest" else 0
    np.testing.assert_allclose(ft[:, :burg], fj[:, :burg], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(ft[:, burg:], fj[:, burg:], rtol=0,
                               atol=FEAT_TOL)
    if mode == "train":
        dt = np.fromfile(outs["t"][1], np.int16).reshape(-1, 2)
        dj = np.fromfile(outs["j"][1], np.int16).reshape(-1, 2)
        np.testing.assert_array_equal(dt[:, 1], dj[:, 1])
        assert _sig_in_agreement(dt, dj)[0] >= SIG_IN_EQUAL
