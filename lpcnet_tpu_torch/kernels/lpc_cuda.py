"""Levinson-Durbin LPC from the inverse transform's lags as one CUDA kernel
(csrc/lpc_levinson.cu) bound to PyTorch: on a CUDA tensor,
ops/dsp.lpc_from_cepstrum computes the band spectrum's inverse FFT with
PyTorch operations and the rest here, in one launch; on a CPU tensor it runs
its plain PyTorch version. There is no fallback: a launch that fails raises.

`launches` counts kernel launches (and nothing else), so a run can show
that it went through the kernel. The library is built and loaded at the
first call, apart from the sample kernels' (sample_cuda.max_clusters).
"""
import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .sample_cuda import _check

LAGS = 17                       # the lags read of a row
ORDER = 16                      # LPC a row

launches = 0

_V = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("lpc_levinson")
    if not getattr(lib, "_lpcnet_typed", False):
        lib.lpcnet_lpc_levinson.argtypes = [_V, ctypes.c_int] + [_V] * 4 + [
            ctypes.c_int, _V]
        lib.lpcnet_lpc_levinson.restype = ctypes.c_int
        lib.lpcnet_lpc_error_string.argtypes = [ctypes.c_int]
        lib.lpcnet_lpc_error_string.restype = ctypes.c_char_p
        lib._lpcnet_typed = True
    return lib


def lpc_from_lags(y: torch.Tensor, lag: torch.Tensor,
                  steps: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (..., n) float32 on a CUDA device, n >= 17, the inverse transform
    irfft(X, n=320) of each row's band spectrum -> (lpc (..., 16), err
    (...)) float32, one launch on the current stream: the lags 320 y[:17],
    the noise floor, the lag window `lag` (16,) and Levinson-Durbin, the
    bits of dsp.lpc_from_bands on the same spectrum. The rows are read in
    place where they lie at one stride with their last axis dense, else
    from a contiguous copy. steps: None, or an int32 (...) tensor that gets
    the Levinson steps each row ran (16 unless it stopped early, 0 where
    ac[0] is 0). Refuses an input that requires grad: the kernel has no
    backward, and no caller differentiates the LPC."""
    global launches
    if y.requires_grad:
        raise ValueError("the LPC kernel has no backward; pass a tensor "
                         "that does not require grad")
    if y.dim() == 0 or y.shape[-1] < LAGS:
        raise ValueError(f"y must be (..., n >= {LAGS}), not "
                         f"{tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"y has dtype {y.dtype}, expected float32")
    if y.device.type != "cuda":
        raise ValueError(f"the LPC kernel runs on a CUDA device, not "
                         f"{y.device}")
    lead = tuple(y.shape[:-1])
    _check("lag", lag, (ORDER,), torch.float32, y.device)
    if steps is not None:
        _check("steps", steps, lead, torch.int32, y.device)
    rows = y.reshape(-1, y.shape[-1])
    n = rows.shape[0]
    if rows.stride(1) != 1 or (n > 1 and rows.stride(0) < LAGS):
        rows = rows.contiguous()
    lpc = torch.empty(lead + (ORDER,), dtype=torch.float32, device=y.device)
    err = torch.empty(lead, dtype=torch.float32, device=y.device)
    if n == 0:
        return lpc, err
    lib = _lib()
    with torch.cuda.device(y.device):
        code = lib.lpcnet_lpc_levinson(
            rows.data_ptr(), rows.stride(0) if n > 1 else LAGS,
            lag.data_ptr(), lpc.data_ptr(), err.data_ptr(),
            None if steps is None else steps.data_ptr(), n,
            torch.cuda.current_stream(y.device).cuda_stream)
    if code != 0:
        raise RuntimeError("LPC kernel launch failed: "
                           + lib.lpcnet_lpc_error_string(code).decode())
    launches += 1
    return lpc, err
