"""Burg's cepstral analysis as one CUDA kernel (csrc/burg_cepstrum.cu) bound
to PyTorch: the card's version of ops/burg.burg_cepstral_analysis, which
sends every CUDA tensor here and runs its plain PyTorch version for
tensors on the CPU. There is no fallback: a launch that fails raises.

`launches` counts kernel launches (and nothing else), so a run can show
that it went through the kernel. The library is built and loaded at the
first call, apart from the sample kernels' (sample_cuda.max_clusters):
a process that never runs Burg on the card never builds it.
"""
import ctypes
from typing import Dict, Optional

import torch

from . import _build
from .sample_cuda import _check

FRAME = 160                     # samples a frame
OUT = 36                        # [.5 (c0 + c1) | c0 - c1]
# the tables the kernel reads, in the order of its C arguments
TABLE_SHAPES = {"bw": (16,), "twiddle": (2, 320), "band": (160, 18),
                "edge": (18,), "dct": (18, 18)}

launches = 0

_V = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("burg_cepstrum")
    if not getattr(lib, "_lpcnet_typed", False):
        lib.lpcnet_burg_cepstrum.argtypes = [_V] * 8 + [ctypes.c_int, _V]
        lib.lpcnet_burg_cepstrum.restype = ctypes.c_int
        lib.lpcnet_burg_error_string.argtypes = [ctypes.c_int]
        lib.lpcnet_burg_error_string.restype = ctypes.c_char_p
        lib._lpcnet_typed = True
    return lib


def burg_cepstral_analysis(pcm: torch.Tensor, tables: Dict[str, torch.Tensor],
                           hit: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """pcm (..., 160) float32 on a CUDA device -> (..., 36) float32, one
    launch on the current stream. tables: TABLE_SHAPES's float32 tensors on
    the same device (ops/burg.kernel_tables). hit: None, or an int32
    (..., 2) tensor that gets 1 where the gain guard hit in that
    half-frame, else 0. Refuses an input that requires grad: the kernel
    has no backward, and Burg only feeds features."""
    global launches
    if pcm.requires_grad:
        raise ValueError("the Burg kernel has no backward; pass a tensor "
                         "that does not require grad")
    if pcm.dim() == 0 or pcm.shape[-1] != FRAME:
        raise ValueError(f"pcm must be (..., {FRAME}), not "
                         f"{tuple(pcm.shape)}")
    if pcm.dtype != torch.float32:
        raise TypeError(f"pcm has dtype {pcm.dtype}, expected float32")
    if not pcm.is_contiguous():
        raise ValueError("pcm must be contiguous")
    if pcm.device.type != "cuda":
        raise ValueError(f"the Burg kernel runs on a CUDA device, not "
                         f"{pcm.device}")
    lead = tuple(pcm.shape[:-1])
    for name, shape in TABLE_SHAPES.items():
        _check(name, tables[name], shape, torch.float32, pcm.device)
        if tables[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies it in 16-byte pieces)")
    if hit is not None:
        _check("hit", hit, lead + (2,), torch.int32, pcm.device)
    out = torch.empty(lead + (OUT,), dtype=torch.float32, device=pcm.device)
    frames = pcm.numel() // FRAME
    if frames == 0:
        return out
    lib = _lib()
    with torch.cuda.device(pcm.device):
        err = lib.lpcnet_burg_cepstrum(
            pcm.data_ptr(), out.data_ptr(),
            None if hit is None else hit.data_ptr(),
            *(tables[name].data_ptr() for name in TABLE_SHAPES), frames,
            torch.cuda.current_stream(pcm.device).cuda_stream)
    if err != 0:
        raise RuntimeError("Burg kernel launch failed: "
                           + lib.lpcnet_burg_error_string(err).decode())
    launches += 1
    return out
