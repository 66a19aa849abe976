"""Precomputed DSP tables, generated at import time (numpy float32).

The same builders as lpcnet_tpu/ops/tables.py, so every table is equal bit
for bit to the JAX package's: the generated lpcnet_tables.c (reference
src/dump_lpcnet_tables.c:83-100), the band layout / compensation constants
of src/freq.c:45-52 and the sampling logit table of src/lpcnet.c:188-191.
"""
from typing import Dict, Tuple

import numpy as np
import torch

from ..constants import NB_BANDS, OVERLAP_SIZE, WINDOW_SIZE_5MS

# Opus-style band edges in units of WINDOW_SIZE_5MS bins (freq.c:45-48).
EBAND5MS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40],
    dtype=np.int32)

# Per-band gain compensation used by lpc_from_cepstrum (freq.c:50-52).
COMPENSATION = np.array(
    [0.8, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.666667, 0.5, 0.5, 0.5,
     0.333333, 0.25, 0.25, 0.2, 0.166667, 0.173913], dtype=np.float32)


def _half_window() -> np.ndarray:
    # Vorbis window: sin(pi/2 * sin^2(pi/2 * (i+.5)/N)) (dump_lpcnet_tables.c:84)
    i = np.arange(OVERLAP_SIZE, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (i + 0.5) / OVERLAP_SIZE)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


HALF_WINDOW = _half_window()


def _dct_table() -> np.ndarray:
    # dct_table[i, j] = cos((i+.5) j pi/NB) (* sqrt(.5) if j==0)
    # (dump_lpcnet_tables.c:90-96)
    i = np.arange(NB_BANDS, dtype=np.float64)[:, None]
    j = np.arange(NB_BANDS, dtype=np.float64)[None, :]
    t = np.cos((i + 0.5) * j * np.pi / NB_BANDS)
    t[:, 0] *= np.sqrt(0.5)
    return t.astype(np.float32)


DCT_TABLE = _dct_table()  # (NB_BANDS, NB_BANDS), row = time idx, col = freq idx


def _sampling_logit_table() -> np.ndarray:
    # -log((1-p)/p), p = .025 + .95*i/255 (lpcnet.c:188-191); C computes in
    # double then stores float.
    i = np.arange(256, dtype=np.float64)
    p = 0.025 + 0.95 * i / 255.0
    return (-np.log((1.0 - p) / p)).astype(np.float32)


SAMPLING_LOGIT_TABLE = _sampling_logit_table()


def _tansig_table() -> np.ndarray:
    # tanh lookup at 0.04 steps; the C header (src/tansig_table.h) stores
    # 6-decimal literals, so round to match the compiled constants exactly.
    x = 0.04 * np.arange(201, dtype=np.float64)
    return np.round(np.tanh(x), 6).astype(np.float32)


TANSIG_TABLE = _tansig_table()


def _band_interp_matrix() -> np.ndarray:
    """(160, NB_BANDS) triangular interpolation weights: row k holds the
    fractional membership of FFT bin k in each band (freq.c:131-154 as a
    fold, freq.c:202-215 as a spread)."""
    nbins = int(EBAND5MS[-1]) * WINDOW_SIZE_5MS  # 160
    W = np.zeros((nbins, NB_BANDS), dtype=np.float32)
    for b in range(NB_BANDS - 1):
        start = int(EBAND5MS[b]) * WINDOW_SIZE_5MS
        size = (int(EBAND5MS[b + 1]) - int(EBAND5MS[b])) * WINDOW_SIZE_5MS
        for j in range(size):
            frac = j / size
            W[start + j, b] += 1.0 - frac
            W[start + j, b + 1] += frac
    return W


BAND_INTERP = _band_interp_matrix()          # (160, 18)

# Edge doubling applied after the fold in compute_band_energy (freq.c:148-149).
BAND_EDGE_SCALE = np.ones(NB_BANDS, dtype=np.float32)
BAND_EDGE_SCALE[0] = 2.0
BAND_EDGE_SCALE[-1] = 2.0


_on_device: Dict[tuple, Tuple[np.ndarray, torch.Tensor]] = {}


def device_constant(a: np.ndarray, device) -> torch.Tensor:
    """The tensor of the module-level numpy constant `a` on `device`, with
    a's values and type: made on the first call and the same tensor on
    every later one. An upload in every call would stall the host on a
    pageable copy each time, and a CUDA graph cannot capture one. Keyed by
    (a's identity, device); the cache holds `a`, so pass constants that
    live as long as their module, never a temporary."""
    key = (id(a), torch.device(device))
    hit = _on_device.get(key)
    if hit is None:
        hit = _on_device[key] = (a, torch.as_tensor(a, device=device))
    return hit[1]
