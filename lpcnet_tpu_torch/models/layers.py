"""Functional NN layers on parameter dictionaries (the port of
lpcnet_tpu/models/layers.py, reference src/nnet.c).

Weight layout as in the JAX package: kernels are (in, out), GRU gates are
ordered [z | r | h] (reset-after), biases split input/recurrent.
"""
import torch

from ..ops import activations


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


def gru_apply(p, h, x, act="tanh", approx=False):
    """Reset-after GRU step from the input x (..., nin): the input product
    and bias, then gru_gates (nnet.c compute_gru2:281-322). Returns the new
    state."""
    return gru_gates(h, x @ p["wi"] + p["bi"], h @ p["wr"] + p["br"], act,
                     approx)


def gru_sequence(p, x, h0, act="tanh", approx=False):
    """Reset-after GRU over a sequence: x (B, T, nin), h0 (B, N) ->
    (B, T, N), the state after each step. The input product is taken once
    for the whole sequence, then gru_gates runs step by step (the scan of
    lpcnet_tpu/models/rdovae.py::_gru_seq and models/plc.py::
    forward_sequence)."""
    zrh = x @ p["wi"] + p["bi"]
    h, hs = h0, []
    for t in range(x.shape[1]):
        h = gru_gates(h, zrh[:, t], h @ p["wr"] + p["br"], act, approx)
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else zrh.new_zeros(
        (x.shape[0], 0, h0.shape[-1]))


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
