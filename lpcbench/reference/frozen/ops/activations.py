"""Activation functions, exact and in the reference's approximate forms
(the port of lpcnet_tpu/ops/activations.py).

The reference C never evaluates a true tanh/sigmoid/exp: it uses a
201-entry table with a 2nd-order correction (src/vec.h:82-104) and a float
bit-trick exp2 (src/vec.h:62-80). cfg.approx selects the table forms; the
default is the exact torch functions.
"""
import torch

from .tables import TANSIG_TABLE, device_constant


def tanh_approx(x: torch.Tensor) -> torch.Tensor:
    """Table-driven tanh (src/vec.h:82-99)."""
    x = x.to(torch.float32)
    sign = torch.where(x < 0, -1.0, 1.0).to(torch.float32)
    ax = torch.abs(x)
    # clamped before the conversion, which overflows above 2^63
    i = torch.clamp(torch.floor(0.5 + 25.0 * ax), 0, 200).to(torch.int64)
    dx = ax - 0.04 * i.to(torch.float32)
    y = device_constant(TANSIG_TABLE, x.device)[i]
    dy = 1.0 - y * y
    y = y + dx * dy * (1.0 - y * dx)
    return sign * y


def sigmoid_approx(x: torch.Tensor) -> torch.Tensor:
    """.5 + .5*tanh_approx(.5*x) (src/vec.h:101-104)."""
    return 0.5 + 0.5 * tanh_approx(0.5 * x)


def lpcnet_exp2(x: torch.Tensor) -> torch.Tensor:
    """Bit-trick 2^x (src/vec.h:62-79): a cubic in the fractional part,
    its float32 bits shifted by the integer part. The JAX package's bits.
    No path of either package calls it or lpcnet_exp: they keep the two
    packages' public functions alike."""
    x = x.to(torch.float32)
    integer = torch.floor(x)
    frac = x - integer
    poly = 0.99992522 + frac * (0.69583354 + frac * (
        0.22606716 + 0.078024523 * frac))
    pi = poly.view(torch.int32)
    pi = (pi + (integer.to(torch.int32) << 23)) & 0x7FFFFFFF
    return torch.where(integer < -50, 0.0, pi.view(torch.float32))


def lpcnet_exp(x: torch.Tensor) -> torch.Tensor:
    """e^x via exp2 (src/vec.h:80)."""
    return lpcnet_exp2(x.to(torch.float32) * 1.44269504)


def get(name: str, approx: bool):
    """Look up an activation by reference name."""
    if name == "tanh":
        return tanh_approx if approx else torch.tanh
    if name == "sigmoid":
        return sigmoid_approx if approx else torch.sigmoid
    if name == "linear":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")
