"""LPC from the cepstrum on the CPU: ops/dsp.lpc_from_cepstrum takes its
plain PyTorch version there, and the CUDA kernel's wrapper
(kernels/lpc_cuda.py) refuses what the kernel does not take before it would
load anything. The kernel's arithmetic (csrc/lpc_levinson.cu: the lags, the
floor, the lag window, Levinson with its sums in the order of PyTorch's
CUDA reduction and both guards) is held here through a numpy copy in
float32, and the card's path around it (dsp._lpc_from_cepstrum_card) runs
here with that copy in the kernel's place; on the card the kernel is held
bit for bit against the plain version (tests/test_torch_cuda.py)."""
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch import features
from lpcnet_tpu_torch.kernels import lpc_cuda
from lpcnet_tpu_torch.ops import dsp

HERE = os.path.dirname(__file__)
F32 = np.float32


def _golden() -> np.ndarray:
    return np.fromfile(os.path.join(HERE, os.pardir, "lpcbench", "data",
                                    "ref_feats.f32"),
                       F32).reshape(-1, 36)[:, :18]


def _speech(frames: int = 64) -> np.ndarray:
    """Cepstra of the first frames of the golden speech (the feature pass,
    on the CPU)."""
    x = np.fromfile(os.path.join(HERE, "golden", "speech.s16"), np.int16)
    pcm = torch.as_tensor(x[:frames * 160].astype(F32)[None])
    _, f, _ = features.compute_features(features.init_state(1), pcm)
    return f[0, :, :18].numpy()


def _peaky() -> np.ndarray:
    """Cepstra of band energies with one peak (and a peak with shoulders)
    of 10^5-10^8 over a flat floor: spectra that Levinson can predict past
    30 dB, so most rows stop early."""
    rows = []
    for peak in (5.0, 6.0, 7.0, 8.0):
        for k in range(0, 18, 2):
            for wide in (False, True):
                log_e = np.zeros(18, F32)
                log_e[k] = peak
                if wide:
                    log_e[max(k - 1, 0)] = log_e[min(k + 1, 17)] = peak / 2
                rows.append(log_e)
    c = dsp.dct(torch.as_tensor(np.stack(rows))).numpy()
    c[:, 0] -= 4.0
    return c


CEPSTRA = {"golden": _golden, "speech": _speech, "peaky": _peaky,
           "zeros": lambda: np.zeros((4, 18), F32)}


def _lags(cep: np.ndarray) -> np.ndarray:
    """The kernel's input: the inverse FFT irfft(X, n=320) of each row's
    band spectrum, as the card's path computes it."""
    x = dsp.interp_band_gain(dsp._band_energies(torch.as_tensor(cep)))
    return torch.fft.irfft(x.to(torch.complex64), n=320, dim=-1).numpy()


def tree_sum(e: np.ndarray) -> np.ndarray:
    """The sum over the last axis (i < 32 floats) in the order of PyTorch's
    CUDA reduction, float32: with w the largest power of two <= i, lane
    x < w holds (0 + e[x]) + (0 + e[x + w]), and the lanes fold at offsets
    w/2, ..., 1."""
    i = e.shape[-1]
    w = 1 << (i.bit_length() - 1)
    t = F32(0) + e[..., :w]
    t[..., :i - w] = t[..., :i - w] + (F32(0) + e[..., w:])
    while w > 1:
        w //= 2
        t = t[..., :w] + t[..., w:2 * w]
    return t[..., 0]


def kernel_numpy(y: np.ndarray):
    """csrc/lpc_levinson.cu's arithmetic in numpy float32, operation by
    operation in its order. y (n, >= 17) -> (lpc (n, 16), err (n,), steps
    (n,))."""
    n = y.shape[0]
    ac = F32(320) * y[:, :17].astype(F32)
    ac[:, 0] = ac[:, 0] + ac[:, 0] * F32(1e-4) + F32(26 / 38)
    ac[:, 1:] = ac[:, 1:] * dsp._LAG
    floor = F32(0.001) * ac[:, 0]
    a = np.zeros((n, 16), F32)
    error = ac[:, 0].copy()
    done = error == 0
    steps = np.zeros(n, np.int32)
    for i in range(16):
        rr = ac[:, 1] if i == 0 else (tree_sum(a[:, :i] * ac[:, i:0:-1])
                                      + ac[:, i + 1])
        r = -rr / np.where(error == 0, F32(1), error)
        new = a.copy()
        new[:, :i] = a[:, :i] + r[:, None] * a[:, i - 1::-1][:, :i]
        new[:, i] = r
        live = ~done
        a = np.where(live[:, None], new, a)
        error = np.where(live, error - r * r * error, error).astype(F32)
        steps = np.where(live, i + 1, steps)
        done = done | (error < floor)
    return a, error, steps


def plain_steps(cep: torch.Tensor) -> torch.Tensor:
    """The Levinson steps each row of lpc_from_cepstrum_plain ran: its
    reflection coefficients are 0 from the step where it stopped."""
    ac = 320 * torch.as_tensor(_lags(cep.numpy()))[..., :17]
    ac0 = ac[..., 0] + ac[..., 0] * 1e-4 + float(F32(26.0 / 38.0))
    ac = torch.cat([ac0[..., None], ac[..., 1:] * torch.as_tensor(dsp._LAG)],
                   dim=-1)
    _, rc, _ = dsp.levinson(ac)
    return (rc != 0).sum(-1).to(torch.int32)


@pytest.mark.parametrize("i", [1, 2, 3, 5, 8, 13, 15])
def test_tree_sum_adds_every_term_once(i):
    """The reduction's order covers each of the i terms once: on powers of
    two it is exact, and on random terms it lies within float32 rounding of
    the float64 sum."""
    e = np.float32(2.0) ** np.arange(i, dtype=F32)[None]
    assert tree_sum(e)[0] == 2.0 ** i - 1
    r = np.random.RandomState(i).randn(64, i).astype(F32)
    exact = r.astype(np.float64).sum(-1)
    scale = np.abs(r).sum(-1)
    assert np.all(np.abs(tree_sum(r) - exact) <= 4 * 2.0 ** -24 * i * scale)


# the numpy copy against the plain version on the CPU: (max |lpc| gap, max
# relative err gap). The CPU sums Levinson's products in another order than
# the card, and the recursion carries that rounding on: 1e-5 where the
# autocorrelation is well conditioned (measured 1.6e-6 and 1.2e-6); on the
# peaky rows, whose prediction error falls 30 dB, the near-singular
# recursion magnifies it (measured 2.2e-3 and 8.7e-4)
KINDS = {"golden": (1e-5, 1e-5), "speech": (1e-5, 1e-5),
         "zeros": (1e-5, 1e-5), "peaky": (1e-2, 1e-2)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_arithmetic_matches_plain(kind):
    """The numpy copy of the kernel on the card path's lags against
    lpc_from_cepstrum_plain on the CPU: the LPC and the error within
    KINDS[kind], and the Levinson steps row for row: the early-exit
    decisions agree. Most peaky rows stop early; no other row does."""
    cep = CEPSTRA[kind]()
    lpc, err, steps = kernel_numpy(_lags(cep))
    want_lpc, want_err = dsp.lpc_from_cepstrum_plain(torch.as_tensor(cep))
    np.testing.assert_array_equal(steps,
                                  plain_steps(torch.as_tensor(cep)).numpy())
    tol_lpc, tol_err = KINDS[kind]
    assert np.abs(lpc - want_lpc.numpy()).max() <= tol_lpc
    np.testing.assert_allclose(err, want_err.numpy(), rtol=tol_err, atol=0)
    if kind == "peaky":
        assert (steps < 16).sum() > len(steps) // 2 and (steps == 16).any()
    else:
        assert (steps == 16).all()


def test_card_path_around_the_kernel(monkeypatch):
    """dsp._lpc_from_cepstrum_card on CPU tensors, the numpy copy in the
    kernel's place: it hands the kernel the inverse FFT of each row of
    features wider than 18 under any leading shape, and gives back the
    plain version's lpc and err shapes and values (within KINDS)."""
    seen = []

    def stand_in(y, lag, steps=None):
        seen.append(tuple(y.shape))
        assert torch.equal(lag, torch.as_tensor(dsp._LAG))
        lpc, err, _ = kernel_numpy(y.reshape(-1, y.shape[-1]).numpy())
        return (torch.as_tensor(lpc).reshape(y.shape[:-1] + (16,)),
                torch.as_tensor(err).reshape(y.shape[:-1]))

    monkeypatch.setattr(lpc_cuda, "lpc_from_lags", stand_in)
    feats = torch.as_tensor(np.fromfile(
        os.path.join(HERE, "golden", "ref_feats.f32"), F32).reshape(
            -1, 36)[:24].reshape(2, 3, 4, 36))
    lpc, err = dsp._lpc_from_cepstrum_card(feats)
    assert seen == [(2, 3, 4, 320)]
    want_lpc, want_err = dsp.lpc_from_cepstrum_plain(feats)
    assert lpc.shape == (2, 3, 4, 16) and err.shape == (2, 3, 4)
    assert (lpc - want_lpc).abs().max() <= KINDS["golden"][0]
    np.testing.assert_allclose(err.numpy(), want_err.numpy(),
                               rtol=KINDS["golden"][1], atol=0)


def test_cpu_tensor_takes_the_plain_path():
    """A CPU tensor runs the plain version: no launch, and its result
    exactly, for any leading shape and for features wider than 18."""
    before = lpc_cuda.launches
    feats = torch.as_tensor(np.fromfile(
        os.path.join(HERE, "golden", "ref_feats.f32"), F32).reshape(
            -1, 36)[:24].reshape(2, 3, 4, 36))
    lpc, err = dsp.lpc_from_cepstrum(feats)
    assert lpc_cuda.launches == before
    assert lpc.shape == (2, 3, 4, 16) and err.shape == (2, 3, 4)
    want_lpc, want_err = dsp.lpc_from_cepstrum_plain(feats[..., :18])
    assert torch.equal(lpc, want_lpc) and torch.equal(err, want_err)


def _refused(case):
    y = torch.zeros(2, 320)
    if case == "grad":
        return y.requires_grad_(), ValueError
    if case == "shape":
        return torch.zeros(2, 16), ValueError
    if case == "dtype":
        return y.double(), TypeError
    return y, ValueError                          # "cpu"


@pytest.mark.parametrize("case", ["grad", "shape", "dtype", "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Before any build or load: an input that requires grad (the kernel has
    no backward), rows of fewer than 17 lags, another type than float32,
    and a tensor off the card."""
    y, err = _refused(case)
    before = lpc_cuda.launches
    with pytest.raises(err):
        lpc_cuda.lpc_from_lags(y, torch.as_tensor(dsp._LAG))
    assert lpc_cuda.launches == before
