"""Activation functions, exact and in the reference's approximate forms
(the port of lpcnet_tpu/ops/activations.py).

The reference C never evaluates a true tanh/sigmoid: it uses a 201-entry
table with a 2nd-order correction (src/vec.h:82-104). cfg.approx selects
those forms; the default is the exact torch functions.
"""
import torch

from .tables import TANSIG_TABLE


def tanh_approx(x: torch.Tensor) -> torch.Tensor:
    """Table-driven tanh (src/vec.h:82-99)."""
    x = x.to(torch.float32)
    sign = torch.where(x < 0, -1.0, 1.0).to(torch.float32)
    ax = torch.abs(x)
    # clamped before the conversion, which overflows above 2^63
    i = torch.clamp(torch.floor(0.5 + 25.0 * ax), 0, 200).to(torch.int64)
    dx = ax - 0.04 * i.to(torch.float32)
    y = torch.as_tensor(TANSIG_TABLE, device=x.device)[i]
    dy = 1.0 - y * y
    y = y + dx * dy * (1.0 - y * dx)
    return sign * y


def sigmoid_approx(x: torch.Tensor) -> torch.Tensor:
    """.5 + .5*tanh_approx(.5*x) (src/vec.h:101-104)."""
    return 0.5 + 0.5 * tanh_approx(0.5 * x)


def get(name: str, approx: bool):
    """Look up an activation by reference name."""
    if name == "tanh":
        return tanh_approx if approx else torch.tanh
    if name == "sigmoid":
        return sigmoid_approx if approx else torch.sigmoid
    if name == "linear":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")
