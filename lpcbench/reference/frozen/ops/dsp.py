"""Spectral DSP: windowing, FFT, band energies, DCT cepstrum, band gain
interpolation and Levinson-Durbin LPC (the port of lpcnet_tpu/ops/dsp.py,
reference src/freq.c). The FFTs are torch.fft's; band folding and the DCT
are small matrix products.

All functions are batched over arbitrary leading dims.
"""
import functools

import numpy as np
import torch

from ..constants import FREQ_SIZE, LPC_ORDER, NB_BANDS, WINDOW_SIZE
from .tables import (BAND_EDGE_SCALE, BAND_INTERP, COMPENSATION, DCT_TABLE,
                     HALF_WINDOW, device_constant)

_DCT_SCALE = float(np.float32(np.sqrt(2.0 / NB_BANDS)))
_NBINS = BAND_INTERP.shape[0]  # 160 interpolated FFT bins
# lag window of lpc_from_bands (freq.c:293-295)
_LAG = (1.0 - 6e-5 * np.arange(1, LPC_ORDER + 1, dtype=np.float32) ** 2)
_WINDOW = np.concatenate([HALF_WINDOW, HALF_WINDOW[::-1]])


def apply_window(x: torch.Tensor) -> torch.Tensor:
    """Vorbis window on both edges (freq.c:322-328). x: (..., WINDOW_SIZE)."""
    return x * device_constant(_WINDOW, x.device)


def forward_transform(x: torch.Tensor) -> torch.Tensor:
    """FFT wrapper (freq.c:242-254): rfft scaled by 1/WINDOW_SIZE.
    x: (..., WINDOW_SIZE) -> complex64 (..., FREQ_SIZE)."""
    return torch.fft.rfft(x.to(torch.float32), n=WINDOW_SIZE,
                          dim=-1) / WINDOW_SIZE


def _power(X: torch.Tensor) -> torch.Tensor:
    return (X.real * X.real + X.imag * X.imag)[..., :_NBINS]


def compute_band_energy(X: torch.Tensor) -> torch.Tensor:
    """18 triangular band energies (freq.c:131-154). X: (..., FREQ_SIZE)
    complex."""
    return _band_sum(_power(X))


def compute_band_energy_inverse(X: torch.Tensor) -> torch.Tensor:
    """Band energies of 1/(|X|^2 + 1e-9) (freq.c:60-84), used by Burg."""
    return _band_sum(1.0 / (_power(X) + 1e-9))


def _band_sum(p: torch.Tensor) -> torch.Tensor:
    """Per-bin values (..., 160) summed into the 18 triangular bands."""
    return (p @ device_constant(BAND_INTERP, p.device)
            * device_constant(BAND_EDGE_SCALE, p.device))


def dct(x: torch.Tensor) -> torch.Tensor:
    """DCT-II, 18-point (freq.c:218-228). x: (..., 18)."""
    dct_m = device_constant(DCT_TABLE, x.device)
    return (x.to(torch.float32) @ dct_m) * _DCT_SCALE


def preemphasis(x: torch.Tensor, mem: torch.Tensor, coef: float = 0.85):
    """y[i] = x[i] - coef*x[i-1], streaming (lpcnet_enc.c:872-880).
    x: (..., N), mem: (...,) the previous input sample. Returns (y,
    new_mem)."""
    x = x.to(torch.float32)
    prev = torch.cat([mem[..., None], x[..., :-1]], dim=-1)
    return x - coef * prev, x[..., -1]


def idct(x: torch.Tensor) -> torch.Tensor:
    """Inverse DCT (freq.c:230-240). x: (..., 18)."""
    dct_m = device_constant(DCT_TABLE, x.device)
    return (x.to(torch.float32) @ dct_m.T) * _DCT_SCALE


def interp_band_gain(bandE: torch.Tensor) -> torch.Tensor:
    """Spread 18 band values to 161 bins (freq.c:202-215). Last bin = 0."""
    g = bandE.to(torch.float32) @ device_constant(BAND_INTERP, bandE.device).T
    return torch.nn.functional.pad(g, (0, FREQ_SIZE - _NBINS))


def inverse_transform(X: torch.Tensor) -> torch.Tensor:
    """Inverse FFT wrapper (freq.c:256-273): WINDOW_SIZE * irfft(X).
    X: (..., FREQ_SIZE) complex -> (..., WINDOW_SIZE) float32."""
    return WINDOW_SIZE * torch.fft.irfft(X, n=WINDOW_SIZE, dim=-1).to(
        torch.float32)


def levinson(ac: torch.Tensor):
    """Levinson-Durbin, order LPC_ORDER (lpcn_lpc, freq.c:86-127).

    ac: (..., LPC_ORDER+1) autocorrelation. Returns (lpc, rc, error) with
    lpc/rc (..., LPC_ORDER). Keeps the reference's early exit at 30 dB
    prediction gain (error < .001*ac[0]) as a per-row `done` mask, and the
    ac[0]==0 guard (such rows never update)."""
    ac = ac.to(torch.float32)
    p = LPC_ORDER
    lpc = torch.zeros(ac.shape[:-1] + (p,), dtype=torch.float32,
                      device=ac.device)
    rc = torch.zeros_like(lpc)
    error = ac[..., 0]
    done = error == 0
    for i in range(p):
        # rr = sum_{j<i} lpc[j] * ac[i-j] + ac[i+1]
        if i > 0:
            rr = (lpc[..., :i] * ac[..., 1:i + 1].flip(-1)).sum(-1) \
                + ac[..., i + 1]
        else:
            rr = ac[..., 1]
        safe_err = torch.where(error == 0, torch.ones_like(error), error)
        r = -rr / safe_err
        # lpc[k] += r*lpc[i-1-k] for k < i, all from pre-update values
        new_lpc = lpc.clone()
        if i > 0:
            new_lpc[..., :i] = lpc[..., :i] + r[..., None] * lpc[..., :i].flip(-1)
        new_lpc[..., i] = r
        new_rc = rc.clone()
        new_rc[..., i] = r
        new_err = error - r * r * error
        nd = ~done
        lpc = torch.where(nd[..., None], new_lpc, lpc)
        rc = torch.where(nd[..., None], new_rc, rc)
        error = torch.where(nd, new_err, error)
        # break AFTER the update when error < .001*ac[0] (freq.c:121-123)
        done = done | (error < 0.001 * ac[..., 0])
    return lpc, rc, error


def lpc_from_bands(Ex: torch.Tensor):
    """Band energies -> LPC via autocorrelation (freq.c:275-297).

    Ex: (..., NB_BANDS). Returns (lpc, error)."""
    Xr = interp_band_gain(Ex)
    x_auto = inverse_transform(Xr.to(torch.complex64))
    ac = x_auto[..., :LPC_ORDER + 1]
    # -40 dB noise floor; the reference writes 320/12/38. with C integer
    # division: 320/12 == 26, so the floor constant is 26/38 (freq.c:292).
    floor_c = float(np.float32(26.0 / 38.0))
    ac0 = ac[..., 0] + ac[..., 0] * 1e-4 + floor_c
    lag = device_constant(_LAG, ac.device)
    ac = torch.cat([ac0[..., None], ac[..., 1:] * lag], dim=-1)
    lpc, _, err = levinson(ac)
    return lpc, err


def lpc_from_cepstrum(cepstrum: torch.Tensor):
    """18 cepstral coeffs -> 16 LPC (freq.c:310-320). cepstrum: (..., >=18)."""
    tmp = cepstrum[..., :NB_BANDS].to(torch.float32).clone()
    tmp[..., 0] += 4.0
    Ex = idct(tmp)
    Ex = torch.pow(10.0, Ex) * device_constant(COMPENSATION, Ex.device)
    return lpc_from_bands(Ex)


def lpc_weighting(lpc: torch.Tensor, gamma: float) -> torch.Tensor:
    """Bandwidth expansion lpc[i] *= gamma^(i+1) (freq.c:299-308)."""
    return lpc * device_constant(_gamma_powers(gamma), lpc.device)


@functools.lru_cache(maxsize=None)
def _gamma_powers(gamma: float) -> np.ndarray:
    """gamma^(i+1) for i < LPC_ORDER, one array per gamma."""
    g = gamma ** np.arange(1, LPC_ORDER + 1, dtype=np.float32)
    return g.astype(np.float32)


def deemphasis_scan(e: torch.Tensor, mem: torch.Tensor, coef: float = 0.85):
    """Streaming de-emphasis y[i] = e[i] + coef*y[i-1] as a parallel
    first-order scan along the last axis: jax.lax.associative_scan's
    odd/even recursion on the pairs (A, B) meaning y = A*y_prev + B, as
    lpcnet_tpu/ops/dsp.py::deemphasis_scan runs it (log2(N) levels of
    elementwise work, no per-sample loop). e: (..., N), mem: (...,) the
    last output before e. Returns (y, new_mem)."""
    e = e.to(torch.float32)
    a = torch.full_like(e, coef)
    b = torch.cat([e[..., :1] + coef * mem[..., None], e[..., 1:]], dim=-1)
    _, y = _first_order_scan(a, b)
    return y, y[..., -1]


def _first_order_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the pairs (a, b) under (x, y) -> (x_a * y_a,
    y_a * x_b + y_b), x before y, in associative_scan's order."""
    n = a.shape[-1]
    if n < 2:
        return a, b

    def combine(xa, xb, ya, yb):
        return xa * ya, ya * xb + yb

    oa, ob = _first_order_scan(*combine(a[..., 0:n - 1:2], b[..., 0:n - 1:2],
                                        a[..., 1::2], b[..., 1::2]))
    m = oa.shape[-1] if n % 2 else oa.shape[-1] - 1
    ea, eb = combine(oa[..., :m], ob[..., :m], a[..., 2::2], b[..., 2::2])
    ea = torch.cat([a[..., :1], ea], dim=-1)
    eb = torch.cat([b[..., :1], eb], dim=-1)

    def interleave(even, odd):
        k = odd.shape[-1]
        both = torch.stack([even[..., :k], odd], dim=-1).flatten(-2)
        return torch.cat([both, even[..., k:]], dim=-1)

    return interleave(ea, oa), interleave(eb, ob)
