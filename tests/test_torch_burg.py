"""Burg's cepstral analysis on the CPU: ops/burg.burg_cepstral_analysis takes
its plain PyTorch version there, and the CUDA kernel's wrapper
(kernels/burg_cuda.py) refuses what the kernel does not take before it
would load anything. The kernel itself is held against the plain version
on the card (tests/test_torch_cuda.py)."""
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch.kernels import burg_cuda
from lpcnet_tpu_torch.ops import burg

HERE = os.path.dirname(__file__)
GOLDEN = np.fromfile(os.path.join(HERE, "golden", "burg.bin"),
                     np.float32).reshape(-1, 160 + 36)
SPEECH = np.fromfile(os.path.join(HERE, "golden", "speech.s16"),
                     np.int16).astype(np.float32)


def _frames() -> np.ndarray:
    """The golden frames and 6 frames of speech."""
    return np.concatenate([GOLDEN[:, :160],
                           SPEECH[8000:8000 + 6 * 160].reshape(6, 160)])


def test_cpu_tensor_takes_the_plain_path():
    """A CPU tensor runs the plain version: no launch, the plain version's
    result exactly, and the reference C's goldens within tests/test_burg.py's
    tolerances."""
    x = torch.as_tensor(_frames())
    got = burg.burg_cepstral_analysis(x)
    assert burg_cuda.launches == 0
    c = burg.burg_cepstrum(torch.stack([x[:, :80], x[:, 80:]]))
    assert torch.equal(got, torch.cat([0.5 * (c[0] + c[1]), c[0] - c[1]],
                                      dim=-1))
    assert torch.equal(got, burg.burg_cepstral_analysis_plain(x))
    n = len(GOLDEN)
    np.testing.assert_allclose(got[:n].numpy(), GOLDEN[:, 160:], rtol=2e-3,
                               atol=5e-3)


@pytest.mark.parametrize("shape", [(160,), (1, 160), (2, 3, 160)])
def test_plain_path_keeps_the_leading_shape(shape):
    """(..., 160) -> (..., 36); each frame as it is alone (1e-5: the
    reductions may group a batch otherwise)."""
    n = int(np.prod(shape[:-1]))
    frames = _frames()[:n]
    got = burg.burg_cepstral_analysis(torch.as_tensor(frames.reshape(shape)))
    assert got.shape == shape[:-1] + (36,)
    alone = torch.cat([burg.burg_cepstral_analysis(torch.as_tensor(f[None]))
                       for f in frames])
    np.testing.assert_allclose(got.reshape(n, 36).numpy(), alone.numpy(),
                               rtol=0, atol=1e-5)


def test_kernel_tables_are_the_kernels_shapes():
    tables = burg.kernel_tables("cpu")
    assert list(tables) == list(burg_cuda.TABLE_SHAPES)
    for name, shape in burg_cuda.TABLE_SHAPES.items():
        assert tables[name].shape == shape
        assert tables[name].dtype == torch.float32
    assert tables["bw"] is burg.kernel_tables("cpu")["bw"]


def test_direct_dft_with_the_twiddles_is_the_rfft():
    """The kernel's spectrum: X[k] = sum_n imp[n] (cos - i sin)[k n mod
    320] over the impulse's 17 taps, the transform rfft(n=320) takes of
    the zero-padded impulse, on the 160 bins the band fold reads (float64
    here: the table's float32 rounding alone)."""
    rs = np.random.RandomState(0)
    imp = np.concatenate([np.ones((8, 1)), rs.randn(8, 16)], 1)
    tw = burg._TWIDDLE.astype(np.float64)
    m = (np.arange(160)[:, None] * np.arange(17)[None]) % 320
    X = imp @ (tw[0][m] - 1j * tw[1][m]).T
    want = np.fft.rfft(imp, n=320)[:, :160]
    np.testing.assert_allclose(X, want, rtol=0,
                               atol=1e-6 * np.abs(imp).sum(1).max())


def _refused(case):
    x = torch.zeros(2, 160)
    if case == "grad":
        return x.requires_grad_(), ValueError
    if case == "shape":
        return torch.zeros(2, 80), ValueError
    if case == "dtype":
        return x.double(), TypeError
    if case == "strided":
        return torch.zeros(160, 2).T, ValueError
    return x, ValueError                          # "cpu"


@pytest.mark.parametrize("case", ["grad", "shape", "dtype", "strided",
                                  "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Before any build or load: an input that requires grad (the kernel has
    no backward), another last axis than 160, another type than float32,
    a strided input, and a tensor off the card."""
    x, err = _refused(case)
    with pytest.raises(err):
        burg_cuda.burg_cepstral_analysis(x, burg.kernel_tables("cpu"))
    assert burg_cuda.launches == 0
