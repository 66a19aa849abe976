"""Vector quantizers of the 1.6 kb/s codec (the port of
lpcnet_tpu/codec/vq.py; reference src/lpcnet_enc.c).

Every search is an exhaustive distance computation against the codebook
and an argmin (vq_quantize_mbest lpcnet_enc.c:53-78, find_nearest_multi
:243-280). The distances keep the JAX package's formula and order of
operations, whose rounding decides near-ties: x2 - 2 (x @ cb.T) + c2, not
torch.cdist. Ties go to the first index, as the C's strict-< updates do:
torch.argmin returns the first minimum, and the M-best beams sort stably
(torch.topk keeps no order among ties). On the card the products are
float32 matmuls with TF32 off (the caller's torch.backends setting; TF32
flips VQ choices).
"""
from typing import Tuple

import torch

from ..constants import FORBIDDEN_INTERP, MULTI_MASK, NB_BANDS


def _dists(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances: x (..., D) vs cb (K, D) -> (..., K)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the codec's distances need float32 matmuls; "
                           "torch.backends.cuda.matmul.allow_tf32 is on, "
                           "and TF32 flips VQ choices")
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (cb * cb).sum(-1)
    return x2 - 2.0 * (x @ cb.T) + c2


def vq_nearest(cb: torch.Tensor, x: torch.Tensor):
    """Nearest codeword (vq_quantize, lpcnet_enc.c:81-101): (index (...,),
    its distance (...,))."""
    d = _dists(x, cb)
    idx = torch.argmin(d, dim=-1)
    return idx, d.gather(-1, idx[..., None])[..., 0]


def _topk_min(d: torch.Tensor, k: int):
    """The k smallest along the last axis, ties in index order ->
    (dists, indices)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def quantize_3stage_mbest(x: torch.Tensor, cb1, cb2, cb3,
                          survivors: int = 5):
    """3-stage residual VQ with M-best beam search
    (quantize_3stage_mbest, lpcnet_enc.c:133-241).

    x: (..., 17). Returns (entries (..., 3) int32, reconstruction
    (..., 17)). The beam keeps `survivors` candidates ranked by cumulative
    residual distance after each stage."""
    S = survivors
    _, i1 = _topk_min(_dists(x, cb1), S)                   # (..., S)
    r1 = x[..., None, :] - cb1[i1]                         # (..., S, 17)
    d2s, i2 = _topk_min(_dists(r1, cb2), S)                # (..., S, S)
    # flatten (k-major) and take the global top S, stable (the C merge)
    flat_d = d2s.reshape(*d2s.shape[:-2], -1)
    _, sel = _topk_min(flat_d, S)
    i1_sel = i1.gather(-1, sel // S)
    i2_sel = i2.reshape(flat_d.shape).gather(-1, sel)
    r2 = x[..., None, :] - cb1[i1_sel] - cb2[i2_sel]
    d3s, i3 = _topk_min(_dists(r2, cb3), S)
    flat_d3 = d3s.reshape(*d3s.shape[:-2], -1)
    _, sel3 = _topk_min(flat_d3, 1)
    k3 = sel3 // S
    e1 = i1_sel.gather(-1, k3)[..., 0]
    e2 = i2_sel.gather(-1, k3)[..., 0]
    e3 = i3.reshape(flat_d3.shape).gather(-1, sel3)[..., 0]
    recon = cb1[e1] + cb2[e2] + cb3[e3]
    return torch.stack([e1, e2, e3], dim=-1).to(torch.int32), recon


def _interp_preds(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The 4 codec predictors (lpcnet_enc.c:294-296): [avg, avg, left,
    right], stacked on a new axis -2."""
    avg = 0.5 * (left + right)
    return torch.stack([avg, avg, left, right], dim=-2)


def quantize_diff(x, left, right, cb, bits: int = 12, sign: bool = True):
    """Multi-predictor signed diff VQ (quantize_diff, lpcnet_enc.c:283-318).

    x/left/right: (..., 18); cb: (2^bits, 18), entry i predicts with
    predictor i & 3. Returns (entry (...,) int32 in [0, 2^(bits+sign)),
    reconstruction (..., 18))."""
    K = cb.shape[0]
    preds = _interp_preds(left, right)                     # (..., 4, 18)
    target = x[..., None, :] - preds                       # (..., 4, 18)
    pred_idx = torch.arange(K, device=cb.device) & MULTI_MASK
    tpc = target[..., pred_idx, :]                         # (..., K, 18)
    d = ((tpc - cb) ** 2).sum(-1)
    if sign:
        d = torch.cat([d, ((tpc + cb) ** 2).sum(-1)], dim=-1)
    entry = torch.argmin(d, dim=-1).to(torch.int32)
    idx = (entry % K).long()
    s = torch.where(entry >= K, -1.0, 1.0)
    pred_sel = preds.gather(-2, (idx & MULTI_MASK)[..., None, None].expand(
        *idx.shape, 1, NB_BANDS))[..., 0, :]
    return entry, pred_sel + s[..., None] * cb[idx]


def interp_search(x, left, right):
    """Best of predictors 1..3 (interp_search, lpcnet_enc.c:320-340).
    Returns (best_pred-1 (...,) int32 in 0..2, dists (..., 3))."""
    preds = _interp_preds(left, right)[..., 1:, :]         # (..., 3, 18)
    d = ((x[..., None, :NB_BANDS] - preds[..., :NB_BANDS]) ** 2).sum(-1)
    return torch.argmin(d, dim=-1).to(torch.int32), d


def double_interp_search(f0, f1, f2, f3, mem):
    """Joint interp choice for frames 0 and 2 (lpcnet_enc.c:379-400).
    All args (..., >=18) cepstra. Returns best_id (...,) int32 in [0, 8)
    (the FORBIDDEN_INTERP combination is excluded and ids above it are
    shifted down)."""
    _, d0 = interp_search(f0, mem, f1)
    _, d1 = interp_search(f2, f1, f3)
    total = d0[..., :, None] + d1[..., None, :]            # (..., 3, 3)
    flat = total.reshape(*total.shape[:-2], 9).clone()
    flat[..., FORBIDDEN_INTERP] = 1e15
    best = torch.argmin(flat, dim=-1).to(torch.int32)
    return best - (best >= FORBIDDEN_INTERP).to(torch.int32)


def single_interp(left, right, idx):
    """Replace a frame by predictor idx in {0: avg, 1: left, 2: right}
    (common.c single_interp:37-56)."""
    preds = torch.stack([0.5 * (left + right), left, right], dim=-2)
    return preds.gather(-2, idx.long()[..., None, None].expand(
        *idx.shape, 1, preds.shape[-1]))[..., 0, :]


def perform_double_interp(f0, f1, f2, f3, mem, best_id):
    """Reconstruct frames 0 and 2 from the interp id
    (common.c perform_double_interp:58-65). Returns (new_f0, new_f2)."""
    bid = best_id + (best_id >= FORBIDDEN_INTERP).to(best_id.dtype)
    return (single_interp(mem, f1, torch.div(bid, 3, rounding_mode="floor")),
            single_interp(f1, f3, bid % 3))
