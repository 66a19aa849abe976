"""Functional NN layers on parameter dictionaries (the port of
lpcnet_tpu/models/layers.py, reference src/nnet.c).

Weight layout as in the JAX package: kernels are (in, out), GRU gates are
ordered [z | r | h] (reset-after), biases split input/recurrent.

The *_init functions give the JAX package's trees, shapes, dtypes and
distributions from an explicit torch.Generator, as float32 tensors on the
CPU. Their values differ from JAX's: the generators differ.
"""
import torch

from ..ops import activations


def _uniform(gen, shape, s):
    return torch.empty(shape, dtype=torch.float32).uniform_(-s, s,
                                                            generator=gen)


def dense_init(gen: torch.Generator, nin, nout, scale=None):
    """Glorot-uniform kernel (nin, nout), zero bias."""
    s = scale if scale is not None else (6.0 / (nin + nout)) ** 0.5
    return {"w": _uniform(gen, (nin, nout), s),
            "b": torch.zeros((nout,), dtype=torch.float32)}


def embedding_init(gen: torch.Generator, num, dim, scale=1.0):
    return {"e": scale * torch.randn((num, dim), generator=gen,
                                     dtype=torch.float32)}


def orthogonal(gen: torch.Generator, n: int, count: int) -> torch.Tensor:
    """count (n, n) matrices drawn uniformly from O(n): the Q of a Gaussian
    matrix's QR with the signs of R's diagonal (jax.random.orthogonal)."""
    q, r = torch.linalg.qr(torch.randn((count, n, n), generator=gen,
                                       dtype=torch.float32))
    return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]


def gru_init(gen: torch.Generator, nin, n):
    """Glorot-uniform input kernel (nin, 3n), an orthogonal recurrent block
    per gate (n, 3n), zero biases."""
    s_in = (6.0 / (nin + 3 * n)) ** 0.5
    return {"wi": _uniform(gen, (nin, 3 * n), s_in),
            "wr": orthogonal(gen, n, 3).permute(1, 0, 2).reshape(n, 3 * n)
            .contiguous(),
            "bi": torch.zeros((3 * n,), dtype=torch.float32),
            "br": torch.zeros((3 * n,), dtype=torch.float32)}


def conv1d_init(gen: torch.Generator, nin, nout, ksize):
    s = (6.0 / (nin * ksize + nout)) ** 0.5
    return {"w": _uniform(gen, (ksize, nin, nout), s),
            "b": torch.zeros((nout,), dtype=torch.float32)}


def dualfc_init(gen: torch.Generator, nin, nout):
    """MDense with 2 channels (training_tf2/mdense.py:73-81)."""
    s = (6.0 / (nin + nout)) ** 0.5
    return {"w": _uniform(gen, (2, nin, nout), s),
            "b": torch.zeros((2, nout), dtype=torch.float32),
            "factor": 1.0 + 0.01 * torch.randn((2, nout), generator=gen,
                                               dtype=torch.float32)}


def dense_apply(p, x, act, approx=False):
    """y = act(x @ w + b)  (reference _lpcnet_compute_dense, nnet.c:122-135)."""
    return activations.get(act, approx)(x @ p["w"] + p["b"])


def embedding_apply(p, idx):
    """Row gather (nnet.c:472-482)."""
    return p["e"][idx.long()]


def gru_gates(h, zrh_in, recur, act="tanh", approx=False):
    """Reset-after GRU update from the input-side preactivation zrh_in
    (input matmul + input bias) and the recurrent one recur (h @ wr + br),
    gate order [z|r|h] (nnet.c compute_gru2:281-322)."""
    n = h.shape[-1]
    sig = activations.get("sigmoid", approx)
    z = sig(zrh_in[..., :n] + recur[..., :n])
    r = sig(zrh_in[..., n:2 * n] + recur[..., n:2 * n])
    hcand = activations.get(act, approx)(zrh_in[..., 2 * n:]
                                         + r * recur[..., 2 * n:])
    return z * h + (1.0 - z) * hcand


def gru_precomputed_apply(p, h, zrh_in, act="tanh", approx=False):
    """GRU step whose input product and input bias are already folded into
    zrh_in (compute_gru3 / compute_sparse_gru, nnet.c:375-448): GRU-A, whose
    inputs are embedding rows precomputed as E @ Wi tables. No path of
    either package calls it: it keeps their public functions alike."""
    return gru_gates(h, zrh_in, h @ p["wr"] + p["br"], act, approx)


def gru_apply(p, h, x, act="tanh", approx=False):
    """Reset-after GRU step from the input x (..., nin): the input product
    and bias, then gru_gates (nnet.c compute_gru2:281-322). Returns the new
    state."""
    return gru_gates(h, x @ p["wi"] + p["bi"], h @ p["wr"] + p["br"], act,
                     approx)


def gru_scan(zrh, h0, wr, br, act="tanh", approx=False, first=None):
    """Reset-after GRU over a sequence from its input-side preactivations
    zrh (B, T, 3N) and h0 (B, N) -> (B, T, N), the state after each step
    (lpcnet_tpu/training/lpcnet_task.py::_gru_scan); first, where given,
    is the first step's recurrent preactivation h0 @ wr + br, computed
    earlier. The outputs are stacked, never written in place, so autograd
    can run through it."""
    h, hs = h0, []
    for t in range(zrh.shape[1]):
        rec = first if t == 0 and first is not None else h @ wr + br
        h = gru_gates(h, zrh[:, t], rec, act, approx)
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else zrh.new_zeros(
        (zrh.shape[0], 0, h0.shape[-1]))


def gru_sequence(p, x, h0, act="tanh", approx=False, first=None):
    """Reset-after GRU over a sequence: x (B, T, nin), h0 (B, N) ->
    (B, T, N). The input product is taken once for the whole sequence,
    then gru_scan runs step by step (the scan of lpcnet_tpu/models/
    rdovae.py::_gru_seq and models/plc.py::forward_sequence); first as
    gru_scan takes it."""
    return gru_scan(x @ p["wi"] + p["bi"], h0, p["wr"], p["br"], act, approx,
                    first)


def dualfc_logits(p, x, approx=False):
    """All-class dual-FC logits, sum_c factor_c * tanh(x @ w_c + b_c)
    (MDense with 2 channels, training_tf2/mdense.py; the C's sample_mdense,
    nnet.c:163-214, evaluates only the rows its tree walk visits).
    x: (..., nin) -> (..., nout)."""
    y = torch.einsum("...i,cio->...co", x, p["w"]) + p["b"]
    return torch.sum(activations.get("tanh", approx)(y) * p["factor"],
                     dim=-2)


def conv1d_step(p, mem, x, act="tanh", approx=False):
    """Streaming conv step with a delay line (nnet.c compute_conv1d:
    452-470). mem: (B, k-1, nin) past inputs; x: (B, nin) the current one.
    Returns (y, new_mem); y belongs to the window that ends at x, the 'same'
    output delayed by (k-1)//2 frames."""
    w = p["w"]
    window = torch.cat([mem, x[:, None, :]], dim=1)        # (B, k, nin)
    y = window[:, 0] @ w[0]
    for j in range(1, w.shape[0]):
        y = y + window[:, j] @ w[j]
    new_mem = window[:, 1:] if w.shape[0] > 1 else mem
    return activations.get(act, approx)(y + p["b"]), new_mem


def conv1d_same_apply(p, x, act="tanh", approx=False):
    """'same'-padded 1D conv over time (training_tf2/lpcnet.py:335-340).
    x: (B, T, nin) -> (B, T, nout); p["w"] is (k, nin, nout).

    Written as k shifted matmuls, not torch's conv1d: cuDNN runs float32
    convolutions in TF32 by default (torch.backends.cudnn.allow_tf32),
    which keeps ~3 decimal digits, while float32 matmuls stay in full
    float32 unless torch.backends.cuda.matmul.allow_tf32 is set. The zero
    padding reproduces the zero-initialised conv state at stream start."""
    w = p["w"]
    k = w.shape[0]
    pad = (k - 1) // 2
    T = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, pad, k - 1 - pad))
    y = xp[:, 0:T] @ w[0]
    for j in range(1, k):
        y = y + xp[:, j:j + T] @ w[j]
    return activations.get(act, approx)(y + p["b"])
