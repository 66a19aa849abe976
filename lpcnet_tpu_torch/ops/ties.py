"""Elementwise functions with JAX's gradients at their ties, for the
training graphs.

Where an operand sits exactly on a kink, JAX and PyTorch send different
gradients back: jnp.abs sends 1 at 0 (torch.abs 0), jnp.clip 0.5 at
either bound (torch.clamp 1). The training losses meet such ties on
zero-initialised parameters, masked frames and saturated mu-law, so they
use these forms. torch.maximum and torch.minimum of two tensors already
split the gradient 0.5 / 0.5 at equality, as jnp.maximum / jnp.minimum do.
The float bound is a 0-d tensor filled on x's device (new_full), never an
upload from the host, so the training steps can be captured as CUDA
graphs.
"""
import torch


class _Abs(torch.autograd.Function):
    """|x| with the gradient select(x >= 0, 1, -1) of jnp.abs."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 - jnp.abs's name
    return _Abs.apply(x)


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c): half the gradient to x where x == c."""
    return torch.maximum(x, x.new_full((), c))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.minimum(x, c): half the gradient to x where x == c."""
    return torch.minimum(x, x.new_full((), c))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi): half the
    gradient at either bound."""
    return minimum(maximum(x, lo), hi)
