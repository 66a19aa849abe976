"""DRED's RDO-VAE encoder in plain PyTorch: the whole history of a few
streams, pair by pair from zero state, in float32 with TF32 off. It
imports nothing of JAX and nothing of the port: the same file is the
port's test reference (lpcnet_tpu_torch/plain/rdovae_encode.py) and the
benchmark's (lpcbench/reference/rdovae_encode.py).

    params = draw_params(seed, sizes)   # the weights of a test or a run
    z, s = encode(params, feats)        # feats (R, 4N, 20): N dframes
    sym, oldest = payloads(params, z, s, at)

params is the RDO-VAE's parameter tree: enc/{dense1, dense3, dense5,
dense7, dense8, gdense1, gdense2}/{w (in, out), b}; enc/{gru2, gru4,
gru6}/{wi (in, 3n), wr (n, 3n), bi, br}, gates ordered [z | r | h];
enc/bits_conv/{w (4, in, 80), b}; quant_embed/e (levels, 6 x 80).
draw_params draws such a tree from a seed, independently of the program
that the tree is then fed to: every bias nonzero, and a scale and a dead
zone of its own for every latent at every lambda level, so that a bias
or a quantizer dropped, doubled or misplaced moves the answers.

The encoder, from the reference's Keras model (training_tf2/rdovae.py:
257-329) and its C inference (src/dred_rdovae_enc.c:38-95,
dred_rdovae_encode_dframe), for each pair of feature frames (40 inputs):
dense1 tanh; GRU; dense3 tanh; GRU; dense5 tanh; GRU; dense7 tanh;
dense8 tanh; the eight outputs joined; the latent, a causal conv of 4
taps over the joined rows of this pair and the 3 before it (zeros before
the stream's start), linear; the decoder's resume state, gdense1 tanh
then gdense2 tanh, PVQ-quantized with 82 pulses (rdovae.py:210-247). The
GRUs are reset-after: z = sigmoid(x Wi_z + bi_z + h Wr_z + br_z), r
likewise, h~ = tanh(x Wi_h + bi_h + r * (h Wr_h + br_h)), h' = z h +
(1 - z) h~. A dframe is two pairs (4 feature frames): its latent and
state are its second pair's.

The payload sent after dframe i (fec_encoder.py:200-209, 242-243): the
latents of dframes i, i-1, ..., i-n+1, newest first, each scaled by the
quantizer of its age and dead-zoned, x - d tanh(x / (0.1 + d)) with
d = 0.05 dead_zone (rdovae.py:103-107), then rounded; the quantizer of
age j is row round(q0 + (q1 - q0) j / (n - 1)) of the lambda embedding,
scale and dead zone its first and second 80 columns through softplus;
and the PVQ state of dframe i-n+1.

Departures from the reference:
- The R rows are independent streams computed side by side; each row is
  what one stream gives alone.
- The conv and the state head run at every pair, as the Keras model runs
  them over its whole sequence; a dframe keeps its second pair's.
- PVQ's result is the quantized unit vector itself: the training code's
  straight-through form x + (q - x) gives it within rounding.
- A payload's latents and state from before the stream's start are
  zeros.
- On a card the pair step runs WARM_PAIRS times eagerly, then as one CUDA
  graph replayed for every further pair: the same operations without a
  host launch for each (a minute of a stream is 3,000 pairs).
"""
import contextlib
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

# pairs run eagerly before the pair step's CUDA graph is captured (the
# first products set up cuBLAS's handle and workspace)
WARM_PAIRS = 2
PVQ_K = 82
PVQ_ITERS = 10
# the state head's hidden width (rdovae.py:279)
STATE_HIDDEN = 128
# every bias is drawn uniform in +-BIAS
BIAS = 0.1
# the lambda embedding is drawn uniform in +-EMBED: through softplus each
# latent of each level gets a scale in 0.13-2.13 and a dead zone of its own
EMBED = 2.0
Params = Dict[str, Dict]


@contextlib.contextmanager
def no_tf32():
    """Float32 products in full float32 while the block runs."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def draw_params(seed: int, sizes: Dict[str, int]) -> Params:
    """The encoder's weights and the lambda embedding, float32 on the CPU,
    drawn from seed at sizes (nb_features, nb_latents, nb_quant,
    cond_size, cond_size2, state_dim): every kernel uniform within
    Glorot's bound sqrt(6 / (fan_in + fan_out)), every bias uniform in
    +-BIAS, the embedding uniform in +-EMBED."""
    gen = torch.Generator().manual_seed(seed)
    nf, nl = sizes["nb_features"], sizes["nb_latents"]
    c, c2 = sizes["cond_size"], sizes["cond_size2"]

    def uniform(shape, bound):
        return (2.0 * torch.rand(shape, generator=gen) - 1.0) * bound

    def glorot(shape, fan_in, fan_out):
        return uniform(shape, (6.0 / (fan_in + fan_out)) ** 0.5)

    def lin(nin, nout):
        return {"w": glorot((nin, nout), nin, nout),
                "b": uniform((nout,), BIAS)}

    def gru(nin, n):
        return {"wi": glorot((nin, 3 * n), nin, 3 * n),
                "wr": glorot((n, 3 * n), n, 3 * n),
                "bi": uniform((3 * n,), BIAS), "br": uniform((3 * n,), BIAS)}
    enc = {"dense1": lin(2 * nf, c2), "gru2": gru(c2, c),
           "dense3": lin(c, c2), "gru4": gru(c2, c), "dense5": lin(c, c2),
           "gru6": gru(c2, c), "dense7": lin(c, c), "dense8": lin(c, c)}
    width = 3 * c2 + 5 * c
    enc["bits_conv"] = {"w": glorot((4, width, nl), 4 * width, nl),
                        "b": uniform((nl,), BIAS)}
    enc["gdense1"] = lin(width, STATE_HIDDEN)
    enc["gdense2"] = lin(STATE_HIDDEN, sizes["state_dim"])
    return {"enc": enc, "quant_embed": {
        "e": uniform((sizes["nb_quant"], 6 * nl), EMBED)}}


def dense(p, x: torch.Tensor, act: str) -> torch.Tensor:
    y = x @ p["w"] + p["b"]
    return torch.tanh(y) if act == "tanh" else y


def gru(p, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One reset-after GRU step (module docstring)."""
    n = h.shape[-1]
    a = x @ p["wi"] + p["bi"]
    b = h @ p["wr"] + p["br"]
    z = torch.sigmoid(a[:, :n] + b[:, :n])
    r = torch.sigmoid(a[:, n:2 * n] + b[:, n:2 * n])
    cand = torch.tanh(a[:, 2 * n:] + r * b[:, 2 * n:])
    return z * h + (1.0 - z) * cand


def pvq(x: torch.Tensor, k: int = PVQ_K, iters: int = PVQ_ITERS
        ) -> torch.Tensor:
    """The unit vector nearest x's direction with k integer pulses, by the
    reference's search (rdovae.py:210-247): the pulses of k x / |x|_1
    rounded, the gain nudged up or down ITERS times until they sum to k.
    x: (..., D)."""
    xn = x / (1e-15 + torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)))
    xl1 = xn / torch.sum(torch.abs(xn), dim=-1, keepdim=True)
    kx = k * xl1
    y = torch.round(kx)
    gain = torch.full_like(y[..., :1], float(k))
    for _ in range(iters):
        total = torch.sum(torch.abs(y), dim=-1, keepdim=True)
        up = 1.000001 * torch.amin((torch.abs(y) + 0.5)
                                   / (torch.abs(kx) + 1e-15), dim=-1,
                                   keepdim=True)
        down = 0.999999 * torch.amax((torch.abs(y) - 0.5)
                                     / (torch.abs(kx) + 1e-15), dim=-1,
                                     keepdim=True)
        nudge = torch.where(total > k, down, up)
        gain = gain * torch.where(total == k, torch.ones_like(nudge), nudge)
        kx = gain * xl1
        y = torch.round(kx)
    return y / (1e-15 + torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True)))


@torch.no_grad()
def encode(params: Params, feats: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (R, 4N, 20): N dframes of R streams from their start.
    Returns every dframe's latent (R, N, 80) and PVQ state (R, N, 24)."""
    with no_tf32():
        z, s = _pairs(params["enc"], feats)
        return z[:, 1::2], pvq(s[:, 1::2])


def _pairs(p, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pair's latent and state before PVQ: (R, P, 80), (R, P, 24)."""
    R, T, nf = feats.shape
    P = T // 2
    x_all = feats.reshape(R, P, 2 * nf).contiguous()
    dev = feats.device
    n = p["gru2"]["wr"].shape[0]
    w, b = p["bits_conv"]["w"], p["bits_conv"]["b"]
    taps, width, nl = w.shape
    ns = p["gdense2"]["w"].shape[1]
    h = torch.zeros((3, R, n), device=dev)
    mem = torch.zeros((R, taps - 1, width), device=dev)
    zs = torch.zeros((R, P, nl), device=dev)
    ss = torch.zeros((R, P, ns), device=dev)
    pos = torch.zeros((1,), dtype=torch.int64, device=dev)

    def step():
        x = x_all.index_select(1, pos)[:, 0]
        o1 = dense(p["dense1"], x, "tanh")
        h2 = gru(p["gru2"], h[0], o1)
        o3 = dense(p["dense3"], h2, "tanh")
        h4 = gru(p["gru4"], h[1], o3)
        o5 = dense(p["dense5"], h4, "tanh")
        h6 = gru(p["gru6"], h[2], o5)
        o7 = dense(p["dense7"], h6, "tanh")
        o8 = dense(p["dense8"], o7, "tanh")
        joined = torch.cat([o1, h2, o3, h4, o5, h6, o7, o8], dim=1)
        window = torch.cat([mem, joined[:, None]], dim=1)
        z = window[:, 0] @ w[0]
        for j in range(1, taps):
            z = z + window[:, j] @ w[j]
        z = z + b
        s = dense(p["gdense2"], dense(p["gdense1"], joined, "tanh"), "tanh")
        zs.index_copy_(1, pos, z[:, None])
        ss.index_copy_(1, pos, s[:, None])
        for i, hi in enumerate((h2, h4, h6)):
            h[i].copy_(hi)
        mem.copy_(window[:, 1:])
        pos.add_(1)

    warm = P if dev.type != "cuda" else min(P, WARM_PAIRS)
    for _ in range(warm):
        step()
    if warm < P:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(P - warm):
            graph.replay()
    return zs, ss


def quant_levels(n: int, q0: int, q1: int) -> torch.Tensor:
    """The quantizer level of each age, newest first: round(q0 + (q1 - q0)
    j / (n - 1)) in float32, halves to even."""
    j = torch.arange(n, dtype=torch.float32)
    return torch.round(q0 + (q1 - q0) * j / max(1, n - 1)).long()


@torch.no_grad()
def payload_values(params: Params, z: torch.Tensor, at: Sequence[int],
                   n: int = 16, q0: int = 3, q1: int = 15) -> torch.Tensor:
    """The payloads' symbols before rounding: (R, A, n, 80), newest
    first, for the dframes `at` (indices into z's second axis). z:
    encode's latents."""
    R, N, nl = z.shape
    dev = z.device
    e = params["quant_embed"]["e"][quant_levels(n, q0, q1).to(dev)]
    scale, d = F.softplus(e[:, :nl]), 0.05 * F.softplus(e[:, nl:2 * nl])
    at = torch.as_tensor(list(at), dtype=torch.int64, device=dev)
    zp = torch.cat([z.new_zeros((R, n - 1, nl)), z], dim=1)
    x = zp[:, at[:, None] + (n - 1) - torch.arange(n, device=dev)] * scale
    return x - d * torch.tanh(x / (0.1 + d))


@torch.no_grad()
def payloads(params: Params, z: torch.Tensor, s: torch.Tensor,
             at: Sequence[int], n: int = 16, q0: int = 3, q1: int = 15
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The payloads sent after dframes `at` (indices into z's second
    axis): symbols (R, A, n, 80) int32, newest first, and the oldest
    dframe's PVQ state (R, A, 24). z, s: encode's outputs."""
    sym = torch.round(payload_values(params, z, at, n, q0, q1))
    at = torch.as_tensor(list(at), dtype=torch.int64, device=z.device)
    sp = torch.cat([s.new_zeros((s.shape[0], n - 1, s.shape[-1])), s],
                   dim=1)
    return sym.to(torch.int32), sp[:, at]
