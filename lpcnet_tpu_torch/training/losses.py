"""Training losses and differentiable DSP helpers for LPCNet (the port of
lpcnet_tpu/training/losses.py):
  - exact-log mu-law pair (training_tf2/tf_funcs.py:17-30)
  - differentiable LPC prediction (tf_funcs.py:36-55)
  - differentiable LPC <-> RC (tf_funcs.py:59-93, dataloader.py:6-14)
  - binary tree -> 256-way pdf expansion (lpcnet.py:66-94)
  - cross-entropy family (lossfuncs.py:95-106, :30-53, :76-93, :108-129)

Every function is differentiable: no host reads, no writes into tensors
autograd saved; gradients follow JAX's at ties (ops/ties.py).
"""
import numpy as np
import torch

from ..ops import ties
from ..ops.tables import device_constant

_SCALE = 255.0 / 32768.0
_SCALE_1 = 32768.0 / 255.0
LOG256 = np.asarray(np.log(256.0), np.float32)     # 0-d
_LOG256 = float(LOG256)


def l2u(x: torch.Tensor) -> torch.Tensor:
    """Continuous mu-law with exact log (tf_funcs.py:17-23). The divisor
    is a tensor on x's device: on CUDA a division by a Python scalar
    becomes a product with its reciprocal, which rounds differently
    (ops/mulaw.py)."""
    u = torch.sign(x) * (128.0 * torch.log1p(_SCALE * ties.abs(x))
                         / device_constant(LOG256, x.device))
    return ties.clip(128.0 + u, 0.0, 255.0)


def u2l(u: torch.Tensor) -> torch.Tensor:
    """Inverse continuous mu-law (tf_funcs.py:26-30)."""
    u = u.to(torch.float32) - 128.0
    return torch.sign(u) * _SCALE_1 * (
        torch.exp(ties.abs(u) / 128.0 * _LOG256) - 1.0)


def diff_pred(x: torch.Tensor, lpc: torch.Tensor,
              frame_size: int = 160) -> torch.Tensor:
    """Differentiable LPC prediction (tf_funcs.py:36-55). x: (B, S) lagged
    signal; lpc: (B, T, order) per-frame coefficients with S == T *
    frame_size. pred[s] = -sum_i lpc[s // fs, i] * x[s - i]."""
    order = lpc.shape[-1]
    S = x.shape[1]
    xp = torch.nn.functional.pad(x, (order, 0))
    lags = torch.stack([xp[:, order - i:order - i + S] for i in range(order)],
                       dim=-1)                                # (B, S, order)
    lpc_rep = lpc.repeat_interleave(frame_size, dim=1)        # (B, S, order)
    return -torch.sum(lags * lpc_rep, dim=-1)


def lpc2rc(lpc: torch.Tensor) -> torch.Tensor:
    """LPC -> reflection coefficients, step-down (dataloader.py:6-14)."""
    order = lpc.shape[-1]
    rcs = [None] * order
    cur = lpc
    for i in range(order, 0, -1):
        ki = cur[..., i - 1]
        rcs[i - 1] = ki
        if i > 1:
            k = ki[..., None]
            cur = (cur[..., :i - 1] - k * cur[..., :i - 1].flip(-1)) \
                / (1.0 - k * k)
    return torch.stack(rcs, dim=-1)


def rc2lpc(rc: torch.Tensor) -> torch.Tensor:
    """RC -> LPC step-up (tf_funcs.py diff_rc2lpc:59-76), in the JAX
    package's order of operations."""
    lpc = rc[..., :1]
    for i in range(1, rc.shape[-1]):
        ki = rc[..., i:i + 1]
        lpc = torch.cat([lpc + ki * lpc.flip(-1), ki], dim=-1)
    return lpc


def tree_to_pdf(p: torch.Tensor) -> torch.Tensor:
    """Expand 256 sigmoid tree-node probabilities into a 256-way leaf pdf
    (training_tf2/lpcnet.py:66-94). p: (..., 256) heap-ordered node
    probabilities (index 0 unused, root at 1). Returns (..., 256): leaf c's
    probability is the product over the 8 levels, root first, of its path's
    node probability or one minus it."""
    out = None
    for b in range(8):
        nodes = p[..., (1 << b):(1 << (b + 1))]              # (..., 2^b)
        both = torch.stack([1.0 - nodes, nodes], dim=-1)     # (..., 2^b, 2)
        level = both.reshape(p.shape[:-1] + (2 << b,)).repeat_interleave(
            256 // (2 << b), dim=-1)
        out = level if out is None else out * level
    return out


def _sparse_ce(pdf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """-log pdf[idx], per element (Keras SparseCategoricalCrossentropy)."""
    p = torch.gather(pdf, -1, idx[..., None].long())[..., 0]
    return -torch.log(ties.maximum(p, 1e-7))


def _interp_pdf(e: torch.Tensor, pdf: torch.Tensor) -> torch.Tensor:
    """pdf interpolated at the continuous mu-law value e, and the index of
    its lower neighbour (lossfuncs.py:76-93)."""
    alpha = (e - torch.floor(e))[..., None]
    e_lo = torch.clamp(e, 0, 254).to(torch.int32)
    return (1 - alpha) * pdf + alpha * torch.roll(pdf, -1, dims=-1), e_lo


def metric_cel(sig_out, preds, pdf):
    """Rounded CE on the mu-law excitation (lossfuncs.py:95-106)."""
    e_gt = torch.clamp(torch.round(l2u(sig_out - preds)), 0, 255)
    return _sparse_ce(pdf, e_gt.to(torch.int32))


def metric_icel(sig_out, preds, pdf):
    """Interpolated CE (lossfuncs.py:76-93)."""
    interp, e_lo = _interp_pdf(l2u(sig_out - preds), pdf)
    return _sparse_ce(interp, e_lo)


def interp_mulaw(sig_out, preds, real_preds, pdf, gamma: float = 1.0):
    """Interpolated + compensated loss for E2E training (lossfuncs.py:
    30-53)."""
    e = l2u(sig_out - preds)
    exc = l2u(sig_out - real_preds)
    prob_comp = ties.abs(e - 128.0) / 128.0 * _LOG256
    reg = ties.abs(exc - 128.0) / 128.0 * _LOG256
    interp, e_lo = _interp_pdf(e, pdf)
    return _sparse_ce(interp, e_lo) + prob_comp + gamma * reg


def metric_exc_sd(sig_out, preds):
    """Excitation spread metric (lossfuncs.py:108-115)."""
    return (l2u(sig_out - preds) - 128.0) ** 2


def loss_matchlar(rc_true, rc_model):
    """Log-area-ratio match for E2E RC outputs (lossfuncs.py:119-129)."""
    def lar(x):
        return torch.log((1.01 + x) / (1.01 - x))
    return torch.mean((lar(rc_model) - lar(rc_true)) ** 2, dim=-1)
