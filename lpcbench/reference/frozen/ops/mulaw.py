"""Mu-law companding, bit-exact with the reference C semantics.

The reference (src/common.h:18-58) goes through `log2_approx`, a float
bit-trick base-2 log with a cubic polynomial on the mantissa. It is
replicated here with float32 <-> int32 bitcasts (`Tensor.view`), one
rounded float32 operation at a time, so the indices match the C and the JAX
package (lpcnet_tpu/ops/mulaw.py) bit for bit.
"""
import numpy as np
import torch

from ..constants import LOG256
from .tables import device_constant


def _c_ulaw2lin_table() -> np.ndarray:
    """The C ulaw2lin (src/common.h:37-45) evaluated for every integer
    mu-law index with its exact promotion semantics: the expression
    `s*scale_1*(exp(u/128.*LOG256)-1)` runs in DOUBLE and rounds to float
    once on return. Excitation indices are always integers, so this
    256-entry table IS the C function, bit for bit."""
    scale_1 = np.float32(np.float32(32768.0) / np.float32(255.0))
    log256 = np.float64(np.float32(LOG256))
    u = np.arange(256, dtype=np.float64) - 128.0
    s = np.where(u >= 0, np.float32(1.0), np.float32(-1.0))
    su = np.float64((s * scale_1).astype(np.float32))
    val = su * (np.exp(np.abs(u) / 128.0 * log256) - 1.0)
    return val.astype(np.float32)


ULAW2LIN_TABLE = _c_ulaw2lin_table()


def log2_approx(x: torch.Tensor) -> torch.Tensor:
    """Bit-trick base-2 log (reference src/common.h:18-33). x must be > 0."""
    xi = x.to(torch.float32).contiguous().view(torch.int32)
    integer = (xi >> 23) - 127
    f = (xi - (integer << 23)).view(torch.float32)
    frac = f - 1.5
    poly = -0.41445418 + frac * (0.95909232 + frac * (
        -0.33951290 + frac * 0.16541097))
    return (1 + integer).to(torch.float32) + poly


def lin2ulaw(x: torch.Tensor) -> torch.Tensor:
    """Linear float sample -> mu-law index in [0, 255] (int32).

    Mirrors src/common.h:47-58 exactly, including the approximate log and the
    floor(.5 + u) rounding. Python float constants combine with float32
    tensors in float32, one rounding per operation. The divisor is a
    tensor: PyTorch turns division by a Python scalar into a multiplication
    by its reciprocal on CUDA, which rounds differently."""
    x = x.to(torch.float32)
    scale = 255.0 / 32768.0                   # exact in float32
    s = torch.where(x >= 0, 1.0, -1.0).to(torch.float32)
    ax = torch.abs(x)
    log_approx = 0.69315 * log2_approx(1.0 + scale * ax)
    log256 = torch.full((1,), LOG256, dtype=torch.float32, device=x.device)
    u = 128.0 + s * (128.0 * log_approx / log256)
    u = torch.clamp(u, 0.0, 255.0)
    return torch.floor(0.5 + u).to(torch.int32)


def ulaw2lin(u: torch.Tensor) -> torch.Tensor:
    """Integer mu-law index -> linear float through ULAW2LIN_TABLE (exact
    with the C's double-exp evaluation)."""
    tbl = device_constant(ULAW2LIN_TABLE, u.device)
    return tbl[torch.clamp(u, 0, 255).long()]
