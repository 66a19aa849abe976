"""Burg LPC analysis (SILK float method) and the Burg cepstrum used by PLC
(the port of lpcnet_tpu/ops/burg.py; reference src/burg.c:98-245
silk_burg_analysis and src/freq.c:156-199 compute_burg_cepstrum /
burg_cepstral_analysis).

The order recursion (16 steps) is unrolled; every step is masked vector
math over the coefficient axis, batched over arbitrary leading dims, with
the operations in the JAX package's order. The reference computes in
double; this is float32, as the JAX package is (~1e-3 against the C
goldens), since the result only feeds log band energies.

LPCNet always calls this with a single subframe (nb_subfr=1,
subfr_length=79, D=16, minInvGain=1e-3), freq.c:170.

burg_cepstral_analysis runs on a CUDA tensor as one kernel
(kernels/burg_cuda.py, csrc/burg_cepstrum.cu), which reads this module's
tables (kernel_tables), and on a CPU tensor as the plain version here
(burg_cepstral_analysis_plain), which the CPU tests hold against JAX.
"""
from typing import Dict, Tuple

import numpy as np
import torch

from ..constants import LPC_ORDER, PREEMPHASIS, WINDOW_SIZE
from ..kernels import burg_cuda
from . import dsp
from .tables import BAND_EDGE_SCALE, BAND_INTERP, DCT_TABLE, device_constant

_COND_FAC = 1e-5  # FIND_LPC_COND_FAC (burg.c:40)
# the inverse filter's bandwidth expansion 0.995^(i+1), i < LPC_ORDER
_BW = 0.995 ** np.arange(1, LPC_ORDER + 1, dtype=np.float32)
# the kernel's DFT twiddles: cos and sin of 2 pi m / WINDOW_SIZE, computed
# in float64
_PHASE = 2.0 * np.pi * np.arange(WINDOW_SIZE) / WINDOW_SIZE
_TWIDDLE = np.stack([np.cos(_PHASE), np.sin(_PHASE)]).astype(np.float32)


def _pad_tail(u: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the last axis on the right to `width`."""
    return torch.nn.functional.pad(u, (0, width - u.shape[-1]))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def burg_analysis(x: torch.Tensor, min_inv_gain: float = 1e-3,
                  order: int = LPC_ORDER) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-subframe Burg analysis. x: (..., L). Returns (A (..., order)
    prediction coefficients, residual energy (...,))."""
    x = x.to(torch.float32)
    L, D = x.shape[-1], order
    batch = x.shape[:-1]
    f32 = dict(dtype=torch.float32, device=x.device)

    C0 = _dot(x, x)
    # C_first[n-1] = <x[0:L-n], x[n:L]>
    C_first = torch.stack([_dot(x[..., :L - n], x[..., n:])
                           for n in range(1, D + 1)], dim=-1)
    C_last = C_first
    CAf = _pad_tail((C0 + _COND_FAC * C0 + 1e-9)[..., None], D + 1)
    CAb = CAf
    Af = torch.zeros(batch + (D,), **f32)
    inv_gain = torch.ones(batch, **f32)
    reached = torch.zeros(batch, dtype=torch.bool, device=x.device)
    iota_d = torch.arange(D, device=x.device)
    iota_d1 = torch.arange(D + 1, device=x.device)

    for n in range(D):
        # tmp1 = x[n] + sum_{k<n} Af[k]*x[n-k-1]
        # tmp2 = x[L-n-1] + sum_{k<n} Af[k]*x[L-n+k]
        if n > 0:
            xf = x[..., :n].flip(-1)                 # x[n-k-1], k=0..n-1
            xb = x[..., L - n:]                      # x[L-n+k]
            tmp1 = x[..., n] + _dot(Af[..., :n], xf)
            tmp2 = x[..., L - n - 1] + _dot(Af[..., :n], xb)
            # C row downdates for k < n
            C_first = C_first - _pad_tail(x[..., n:n + 1] * xf, D)
            C_last = C_last - _pad_tail(x[..., L - n - 1:L - n] * xb, D)
        else:
            tmp1 = x[..., n]
            tmp2 = x[..., L - n - 1]
        # CAf[k] -= tmp1 * x[n-k], CAb[k] -= tmp2 * x[L-n+k-1] for k <= n
        CAf = CAf - _pad_tail(tmp1[..., None] * x[..., :n + 1].flip(-1),
                              D + 1)
        CAb = CAb - _pad_tail(tmp2[..., None] * x[..., L - n - 1:], D + 1)
        # next-row terms
        t1 = C_first[..., n]
        t2 = C_last[..., n]
        if n > 0:
            t1 = t1 + _dot(C_last[..., :n].flip(-1), Af[..., :n])
            t2 = t2 + _dot(C_first[..., :n].flip(-1), Af[..., :n])
        CAf = torch.where(iota_d1 == n + 1, t1[..., None], CAf)
        CAb = torch.where(iota_d1 == n + 1, t2[..., None], CAb)

        num = CAb[..., n + 1]
        nrg_b = CAb[..., 0]
        nrg_f = CAf[..., 0]
        if n > 0:
            # CAb[n], CAb[n-1], ... CAb[1] against Af[0..n-1]
            num = num + _dot(CAb[..., 1:n + 1].flip(-1), Af[..., :n])
            nrg_b = nrg_b + _dot(CAb[..., 1:n + 1], Af[..., :n])
            nrg_f = nrg_f + _dot(CAf[..., 1:n + 1], Af[..., :n])
        rc = -2.0 * num / (nrg_f + nrg_b)

        # max-prediction-gain guard (burg.c:179-192)
        tmp_g = inv_gain * (1.0 - rc * rc)
        hit = tmp_g <= min_inv_gain
        rc_adj = torch.sqrt(torch.clamp(1.0 - min_inv_gain / inv_gain,
                                        min=0.0))
        rc_adj = torch.where(num > 0, -rc_adj, rc_adj)
        rc = torch.where(hit, rc_adj, rc)
        new_inv_gain = torch.where(hit, min_inv_gain, tmp_g)

        # AR update (symmetric, from pre-update values):
        #   Af[k] += rc * Af[n-1-k] for k < n (the middle element of an
        #   odd n pairs with itself), Af[n] = rc
        half = (n + 1) >> 1
        if half > 0:
            partner = _pad_tail(Af[..., :n].flip(-1), D)   # Af[n-1-k]
            upd_mask = (iota_d < half) | ((iota_d >= n - half)
                                          & (iota_d < n))
            Af_n = torch.where(upd_mask, Af + rc[..., None] * partner, Af)
        else:
            Af_n = Af
        Af_n = torch.where(iota_d == n, rc[..., None], Af_n)
        # freeze everything once max gain was reached in an earlier step
        Af = torch.where(reached[..., None], Af, Af_n)
        inv_gain = torch.where(reached, inv_gain, new_inv_gain)

        # CAf/CAb cross update over indices 0..n+1 (burg.c:212-216), from
        # pre-update values
        upd = ~(reached | hit)[..., None] & (iota_d1 <= n + 1)
        CAf_n = CAf + rc[..., None] * _pad_tail(CAb[..., :n + 2].flip(-1),
                                                D + 1)
        CAb_n = CAb + rc[..., None] * _pad_tail(CAf[..., :n + 2].flip(-1),
                                                D + 1)
        CAf = torch.where(upd, CAf_n, CAf)
        CAb = torch.where(upd, CAb_n, CAb)
        reached = reached | hit

    # residual energy (burg.c:219-241)
    nrg_hit = (C0 - _dot(x[..., :D], x[..., :D])) * inv_gain
    nrg_nohit = CAf[..., 0] + _dot(CAf[..., 1:], Af) \
        - _COND_FAC * C0 * (1.0 + _dot(Af, Af))
    return -Af, torch.where(reached, nrg_hit, nrg_nohit)


def burg_cepstrum(pcm: torch.Tensor) -> torch.Tensor:
    """Burg cepstrum of one half-frame (compute_burg_cepstrum,
    freq.c:156-186). pcm: (..., 80). Returns (..., 18)."""
    from ..features import log_follower
    L, order = pcm.shape[-1], LPC_ORDER
    xin = pcm[..., 1:] - PREEMPHASIS * pcm[..., :-1]     # (..., L-1)
    lpc, g = burg_analysis(xin, 1e-3, order)
    g = g / (L - 2 * (order - 1))
    # inverse filter spectrum: impulse [1, -lpc*0.995^(i+1), 0...]
    bw = device_constant(_BW, pcm.device)
    imp = torch.nn.functional.pad(
        torch.cat([torch.ones_like(lpc[..., :1]), -lpc * bw], dim=-1),
        (0, WINDOW_SIZE - order - 1))
    E = dsp.compute_band_energy_inverse(dsp.forward_transform(imp))
    E = E * (0.45 * g[..., None] * (1.0 / WINDOW_SIZE ** 3))
    ceps = dsp.dct(log_follower(torch.log10(1e-2 + E)))
    return torch.cat([ceps[..., :1] - 4.0, ceps[..., 1:]], dim=-1)


def kernel_tables(device) -> Dict[str, torch.Tensor]:
    """The Burg kernel's tables on `device` (burg_cuda.TABLE_SHAPES), kept
    there by device_constant, so a CUDA graph captures no upload."""
    return {"bw": device_constant(_BW, device),
            "twiddle": device_constant(_TWIDDLE, device),
            "band": device_constant(BAND_INTERP, device),
            "edge": device_constant(BAND_EDGE_SCALE, device),
            "dct": device_constant(DCT_TABLE, device)}


def burg_cepstral_analysis(pcm: torch.Tensor) -> torch.Tensor:
    """Sum/difference Burg cepstra of the two half-frames
    (burg_cepstral_analysis, freq.c:188-199). pcm: (..., 160) ->
    (..., 36) [.5*(c0+c1) | (c0-c1)]. A CUDA tensor goes through the
    kernel (one launch), any other through the plain version."""
    if pcm.device.type == "cuda":
        return burg_cuda.burg_cepstral_analysis(
            pcm.to(torch.float32).contiguous(), kernel_tables(pcm.device))
    return burg_cepstral_analysis_plain(pcm)


def burg_cepstral_analysis_plain(pcm: torch.Tensor) -> torch.Tensor:
    """burg_cepstral_analysis in PyTorch operations on any device. The two
    half-frames go through the recursion as one stacked batch."""
    c = burg_cepstrum(torch.stack([pcm[..., :80], pcm[..., 80:160]]))
    return torch.cat([0.5 * (c[0] + c[1]), c[0] - c[1]], dim=-1)
