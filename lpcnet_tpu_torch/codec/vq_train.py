"""Codebook training of the 1.6 kb/s codec (the port of
lpcnet_tpu/codec/vq_train.py, which replaces the reference's offline tool
src/ceps_vq_train.c): kmeans (vq_train, ceps_vq_train.c:338-366),
kmeans_multi (vq_train_multi, :368-403), kmeans_weighted
(vq_train_weighted, :406-431) and the data recipe of its main()
(:433-619) in train_codec_codebooks.

Split k-means: start from one centroid, double the codebook by
perturbation, Lloyd-iterate (4 passes per split, 20 at full size: the
C's counts). An assignment is one (N, D) x (D, K) distance product in
float32, which refuses to run on the card while TF32 is allowed, and the
first minimum wins, as in codec/vq.py. Empty cells are re-seeded from
random data points, as the JAX package does. Random draws come from an
explicit torch.Generator on the data's device.

A Lloyd pass of kmeans and an update of kmeans_multi are jit entry points
(utils/graphs.py), as the JAX package jits them (lpcnet_tpu/codec/
vq_train.py:73, :226), with the corpus and the generator as arguments: on
the card each codebook size runs its first pass eagerly, captures the
second and replays the others; the generator is registered with the
graph. On the card the segment sums are index_put_ with accumulate, which
gives the same bits in every run (index_add_ adds with atomics there, in
another order in every run); on the CPU they are index_add_.
"""
from typing import Dict

import torch

from ..constants import NB_BANDS
from ..device import refuse_tf32
from ..utils import graphs

_ASSIGN_CHUNK = 8192   # rows per distance matrix when N x K is large


def _assign(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    refuse_tf32(x, "the VQ trainer's distances (TF32 flips assignments)")
    d = ((x * x).sum(-1, keepdim=True) - 2 * (x @ cb.T)
         + (cb * cb).sum(-1))
    return torch.argmin(d, dim=-1)


def _chunks(N: int, K: int):
    """Row slices that bound the (rows, K) distance matrix."""
    if N * K <= _ASSIGN_CHUNK * 16384:
        return [slice(0, N)]
    return [slice(i, i + _ASSIGN_CHUNK) for i in range(0, N, _ASSIGN_CHUNK)]


def _assign_chunked(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    return torch.cat([_assign(x[s], cb) for s in _chunks(x.shape[0],
                                                         cb.shape[0])])


def _segment_sum(v: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros((k,) + v.shape[1:], dtype=v.dtype, device=v.device)
    if v.is_cuda:
        return out.index_put_((idx,), v, accumulate=True)
    return out.index_add_(0, idx, v)


def _update(x: torch.Tensor, assign: torch.Tensor, k: int):
    sums = _segment_sum(x, assign, k)                                # (K, D)
    counts = _segment_sum(torch.ones_like(x[:, 0]), assign, k)       # (K,)
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def _reseed_empty(gen: torch.Generator, cb: torch.Tensor,
                  counts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    repl = x[torch.randint(0, x.shape[0], (cb.shape[0],), generator=gen,
                           device=x.device)]
    return torch.where((counts > 0)[:, None], cb, repl)


@torch.no_grad()
def _lloyd_pass(cb: torch.Tensor, gen: torch.Generator,
                x: torch.Tensor) -> torch.Tensor:
    new_cb, counts = _update(x, _assign_chunked(x, cb), cb.shape[0])
    return _reseed_empty(gen, new_cb, counts, x)


# lloyd(cb, gen, x): one Lloyd pass (JAX's jitted _lloyd_pass)
lloyd = graphs.jit(_lloyd_pass, "vq_train.lloyd")


def _split(gen: torch.Generator, cb: torch.Tensor,
           spread: torch.Tensor) -> torch.Tensor:
    """The codebook doubled: each entry -/+ 0.02 N(0, 1) * spread."""
    noise = 0.02 * torch.randn(cb.shape, generator=gen,
                               device=cb.device) * spread
    return torch.cat([cb - noise, cb + noise], dim=0)


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int, iters: int = 4,
           final_iters: int = 20) -> torch.Tensor:
    """Split-init k-means: x (N, D) -> (k, D) codebook; iters Lloyd passes
    per split, final_iters at full size."""
    cb = torch.mean(x, dim=0, keepdim=True)
    spread = torch.std(x, dim=0, correction=0)
    while cb.shape[0] < k:
        cb = _split(gen, cb, spread)
        for _ in range(iters):
            cb = lloyd(cb, gen, x)
    for _ in range(final_iters):
        cb = lloyd(cb, gen, x)
    return cb[:k]


def kmeans_weighted(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor,
                    k: int, iters: int = 4,
                    final_iters: int = 20) -> torch.Tensor:
    """Weighted split k-means (vq_train_weighted). w: (N, D) weights per
    vector and dimension; the assignment minimises sum_j w (x - c)^2
    (find_nearest_weighted, :92-108), the update is the sqrt(w)-weighted
    mean (update_weighted, :285-318). The codebook doubles at each split,
    as in kmeans (the C grows it one entry at a time)."""
    refuse_tf32(x, "the VQ trainer's distances (TF32 flips assignments)")

    def assign_w(cb):
        return torch.cat([torch.argmin(
            (w[s] * x[s] * x[s]).sum(-1, keepdim=True)
            - 2 * (w[s] * x[s]) @ cb.T + w[s] @ (cb * cb).T, dim=-1)
            for s in _chunks(x.shape[0], cb.shape[0])])

    cb = torch.sum(x, dim=0, keepdim=True) / x.shape[0]
    spread = torch.std(x, dim=0, correction=0)
    sw = torch.sqrt(w)
    while cb.shape[0] < k:
        cb = _split(gen, cb, spread)
        cur = cb.shape[0]
        for _ in range(iters if cur < k else iters + final_iters):
            a = assign_w(cb)
            new_cb = _segment_sum(sw * x, a, cur) / torch.clamp(
                _segment_sum(sw, a, cur), min=1e-9)
            cb = _reseed_empty(gen, new_cb, _segment_sum(
                torch.ones_like(x[:, 0]), a, cur), x)
    return cb[:k]


def _assign_multi(targets: torch.Tensor, cb: torch.Tensor, sign: bool):
    """Assignment of the multi-predictor codebook (find_nearest_multi,
    :53-90): entry e quantizes the residual of predictor e % 4; with sign,
    the negated entries are candidates too. targets: (N, 4, D); cb: (K, D).
    Returns (entry (N,) int64, sign (N,) +-1), the first best kept."""
    refuse_tf32(targets, "the VQ trainer's distances (TF32 flips "
                "assignments)")
    N, P, _ = targets.shape
    es, ss = [], []
    for s in _chunks(N, cb.shape[0] // P):
        tc = targets[s]
        best_d = torch.full((tc.shape[0],), 1e15, device=tc.device)
        best_e = torch.zeros((tc.shape[0],), dtype=torch.int64,
                             device=tc.device)
        best_s = torch.ones((tc.shape[0],), device=tc.device)
        for p in range(P):
            cbp = cb[p::P]
            t = tc[:, p]
            t2 = (t * t).sum(-1, keepdim=True)
            c2 = (cbp * cbp).sum(-1)
            dots = t @ cbp.T
            for sg in ((1.0, -1.0) if sign else (1.0,)):
                d = t2 - 2 * sg * dots + c2
                j = torch.argmin(d, dim=-1)
                dj = d.gather(-1, j[:, None])[:, 0]
                upd = dj < best_d
                best_d = torch.where(upd, dj, best_d)
                best_e = torch.where(upd, j * P + p, best_e)
                best_s = torch.where(upd, sg, best_s)
        es.append(best_e)
        ss.append(best_s)
    return torch.cat(es), torch.cat(ss)


def kmeans_multi(gen: torch.Generator, targets: torch.Tensor, k: int,
                 iters: int = 4, final_iters: int = 20,
                 sign: bool = True) -> torch.Tensor:
    """Multi-predictor k-means (vq_train_multi): entry e quantizes the
    residual of predictor e % 4, with a sign bit if sign. targets:
    (N, 4, D) residuals against the 4 predictors. Per-predictor mean init
    plus jitter, 10 warm-up updates, split-doubling to k with iters
    updates per split, final_iters at full size."""
    N, P, D = targets.shape
    cb = torch.mean(targets, dim=0) + 0.01 * (torch.rand(
        (P, D), generator=gen, device=targets.device) - 0.5)
    spread = torch.std(targets.reshape(-1, D), dim=0, correction=0)
    for _ in range(10):
        cb = multi_update(cb, gen, targets, sign)
    while cb.shape[0] < k:
        cb = _split(gen, cb, spread)
        for _ in range(iters):
            cb = multi_update(cb, gen, targets, sign)
    for _ in range(final_iters):
        cb = multi_update(cb, gen, targets, sign)
    return cb[:k]


@torch.no_grad()
def _multi_update(cb: torch.Tensor, gen: torch.Generator,
                  targets: torch.Tensor, sign: bool) -> torch.Tensor:
    """One update of kmeans_multi: assignment, signed means, empty cells
    re-seeded from the residual of their own predictor."""
    N, P, _ = targets.shape
    e, s = _assign_multi(targets, cb, sign)
    t_sel = targets[torch.arange(N, device=targets.device), e % P]
    K = cb.shape[0]
    counts = _segment_sum(torch.ones_like(s), e, K)
    new_cb = _segment_sum(s[:, None] * t_sel, e, K) / torch.clamp(
        counts, min=1.0)[:, None]
    ridx = torch.randint(0, N, (K,), generator=gen, device=targets.device)
    repl = targets[ridx, torch.arange(K, device=targets.device) % P]
    return torch.where((counts > 0)[:, None], new_cb, repl)


# multi_update(cb, gen, targets, sign): JAX's jitted upd of
# vq_train_multi (vq_train.py:226)
multi_update = graphs.jit(_multi_update, "vq_train.kmeans_multi.upd")


def train_codec_codebooks(gen: torch.Generator, feats: torch.Tensor,
                          iters: int = 4, final_iters: int = 20
                          ) -> Dict[str, torch.Tensor]:
    """The codec's codebook set from a feature corpus, by the recipe of
    ceps_vq_train.c main() (:433-619): feats (N, >= 18) consecutive
    frames. cb1/cb2/cb3 are a 3-stage residual cascade over every frame's
    17 cepstra after c0 (:476-481); diff4 is trained on frame i+2's
    residuals against the quantized reconstructions of frames i and i+4
    (:490-546), what the decoder's predictors see. Sizes: 1024 entries
    each for cb1-cb3, 4096 for diff4, the shipped codebooks'."""
    data = feats[:, :NB_BANDS]
    x = data[:, 1:]                                    # (N, 17)
    cbs, r = {}, x
    for name in ("cb1", "cb2", "cb3"):
        cbs[name] = kmeans(gen, r, 1024, iters, final_iters)
        r = r - cbs[name][_assign_chunked(r, cbs[name])]
    qdata = torch.cat([data[:, :1], x - r], dim=-1)    # c0 kept raw
    N = data.shape[0]
    tgt = data[2:N - 2]
    left, right = qdata[:N - 4], qdata[4:]
    avg = 0.5 * (left + right)
    targets = torch.stack([tgt - avg, tgt - avg, tgt - left, tgt - right],
                          dim=1)                       # (N-4, 4, 18)
    cbs["diff4"] = kmeans_multi(gen, targets, 4096, iters,
                                final_iters, sign=True)
    return cbs
