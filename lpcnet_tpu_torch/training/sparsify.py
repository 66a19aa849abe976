"""Progressive block sparsification and int8 quantization of the GRU
weights (the port of lpcnet_tpu/training/sparsify.py; reference Keras
callbacks training_tf2/lpcnet.py:110-256):
  * Sparsify: GRU-A's recurrent kernel pruned per gate to a target
    density by 4x8 block magnitude, the diagonal always kept, the density
    annealed on a cubic schedule between t_start and t_end batches;
  * SparsifyGRUB: the same on the first gru_a_units rows of GRU-B's input
    kernel (the rows GRU-A's state feeds);
  * progressive quantization: weights whose residual to round(128 w)/128
    is below an annealed threshold snap to the grid.

Applied after the optimizer update, under torch.no_grad(), as the
reference applies them on_batch_end. The schedule's scalars are computed
in numpy float32, as JAX computes them from its int32 batch counter, so
the same weights and step give the same blocks.
"""
import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SparsifyConfig:
    # from-scratch schedule (train_lpcnet.py:303-317)
    t_start: int = 2000
    t_end: int = 40000
    interval: int = 400
    density: Tuple[float, float, float] = (0.05, 0.05, 0.2)  # z, r, h gates
    grub_density: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    quantize: bool = False


def _f32(x) -> np.float32:
    return np.float32(x)


def _cubic_density(final_density: float, batch: int, t_start: int,
                   t_end: int) -> np.float32:
    r = _f32(1.0) - _f32(batch - t_start) / _f32(t_end - t_start)
    r = np.clip(r, _f32(0.0), _f32(1.0))
    return _f32(1.0) - _f32(1.0 - final_density) * (_f32(1.0) - r * r * r)


def _block_mask(A: torch.Tensor, density: np.float32,
                keep_diag: bool) -> torch.Tensor:
    """4x8 block magnitude mask of one gate's kernel A (N_in, N_out)
    (lpcnet.py:145-160), blocked as the reference blocks A.T (out/4, 4,
    in/8, 8). Returns a 0/1 mask of A's shape."""
    At = A.T
    out_n, in_n = At.shape
    L = At.reshape(out_n // 4, 4, in_n // 8, 8)
    S = torch.sum(L * L, dim=(1, 3))                 # (out/4, in/8)
    flat = torch.sort(S.reshape(-1)).values
    n = S.numel()
    k = int(np.clip(np.round(_f32(n) * (_f32(1.0) - _f32(density))), 0,
                    n - 1))
    mask = (S >= flat[k]).to(A.dtype)
    mask = mask.repeat_interleave(4, dim=0).repeat_interleave(8, dim=1)
    if keep_diag:
        mask = torch.clamp(mask + torch.eye(out_n, in_n, dtype=A.dtype,
                                            device=A.device), max=1.0)
    return mask.T


def _fires(batch: int, cfg: SparsifyConfig) -> bool:
    return ((batch > cfg.t_start
             and (batch - cfg.t_start) % cfg.interval == 0)
            or batch >= cfg.t_end)


def _density(fd: float, batch: int, cfg: SparsifyConfig) -> np.float32:
    return _f32(fd) if cfg.quantize else _cubic_density(
        fd, batch, cfg.t_start, cfg.t_end)


def sparsify_gru_a(wr: torch.Tensor, batch: int,
                   cfg: SparsifyConfig) -> torch.Tensor:
    """Prune GRU-A's recurrent kernel (N, 3N) per gate (lpcnet.py:110-181);
    between firings it passes through."""
    if not (cfg.quantize or _fires(batch, cfg)):
        return wr
    n = wr.shape[0]
    outs = []
    for k, fd in enumerate(cfg.density):
        A = wr[:, k * n:(k + 1) * n]
        # the reference scores without the diagonal, then keeps it
        A_nodiag = A - torch.diag(torch.diag(A))
        outs.append(A * _block_mask(A_nodiag, _density(fd, batch, cfg),
                                    keep_diag=True))
    return torch.cat(outs, dim=1)


def sparsify_gru_b_input(wi: torch.Tensor, grua_units: int, batch: int,
                         cfg: SparsifyConfig) -> torch.Tensor:
    """Prune the GRU-A-fed rows of GRU-B's input kernel (in, 3N)
    (SparsifyGRUB, lpcnet.py:184-256)."""
    if not (cfg.quantize or _fires(batch, cfg)):
        return wi
    n = wi.shape[1] // 3
    top = wi[:grua_units]
    outs = []
    for k, fd in enumerate(cfg.grub_density):
        A = top[:, k * n:(k + 1) * n]
        outs.append(A * _block_mask(A, _density(fd, batch, cfg),
                                    keep_diag=False))
    return torch.cat([torch.cat(outs, dim=1), wi[grua_units:]], dim=0)


def progressive_quantize(w: torch.Tensor, batch: int, t_start: int,
                         t_end: int) -> torch.Tensor:
    """Snap weights near the int8/128 grid (lpcnet.py:162-178); the snap
    threshold anneals 0 -> 0.5 over [t_start, t_end]."""
    thr = (_f32(0.5) * _f32(batch - t_start) / _f32(t_end - t_start)
           if batch < t_end else _f32(0.5))
    thr = float(np.clip(thr, _f32(0.0), _f32(0.5)))
    q = torch.round(w * 128.0)
    res = w * 128.0 - q
    snap = (torch.abs(res) <= thr).to(w.dtype)
    return snap * q / 128.0 + (1 - snap) * w


@torch.no_grad()
def apply(params, batch: int, cfg: SparsifyConfig, grua_units: int):
    """Post-update hook: sparsify GRU-A's recurrent and GRU-B's input
    kernels, with progressive quantization when cfg.quantize."""
    ga = dict(params["gru_a"])
    gb = dict(params["gru_b"])
    ga["wr"] = sparsify_gru_a(ga["wr"], batch, cfg)
    gb["wi"] = sparsify_gru_b_input(gb["wi"], grua_units, batch, cfg)
    if cfg.quantize and _fires(batch, cfg):
        ga["wr"] = progressive_quantize(ga["wr"], batch, cfg.t_start,
                                        cfg.t_end)
        gb["wi"] = progressive_quantize(gb["wi"], batch, cfg.t_start,
                                        cfg.t_end)
    return dict(params, gru_a=ga, gru_b=gb)


def measure_density(w: torch.Tensor) -> float:
    """Fraction of nonzero weights (diagnostic)."""
    return float(torch.mean((w != 0).to(torch.float32)))
