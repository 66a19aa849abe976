"""Operations and bytes of LPCNet's work, counted from the configuration's
shapes by the model's own arithmetic, never by one implementation's.

The sample loop's count is the reference C engine's per sample and stream
(nnet.c:410-448, lpcnet.c:235-271): GRU-A's recurrent product (Na x 3Na),
GRU-B's input product from GRU-A's state (Na x 3Nb) and its recurrent one
(Nb x 3Nb), and the dual FC's two channels (2 x Nb x levels). The three
mu-law embedding rows of GRU-A's input are table reads there, and the
sampler a walk of 8 nodes, so neither counts. For LPCNetConfig() that is
2 x 469,760 per sample.

PEAKS holds the card's published rates (NVIDIA H100 SXM data sheet, dense,
at the full 700 W power limit): float32 outside the tensor cores, and HBM3
bandwidth. The configurations state float32 with TF32 off, so float32's
peak is the one that applies.
"""
from typing import Dict

PEAKS = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
F32 = 4


def sample_flops(s: Dict[str, int]) -> int:
    """Operations per sample and stream of the 16 kHz loop."""
    na, nb, lv = s["gru_a_units"], s["gru_b_units"], s["pcm_levels"]
    return 2 * (na * 3 * na + na * 3 * nb + nb * 3 * nb + 2 * nb * lv)


def frame_flops(s: Dict[str, int]) -> int:
    """Operations per frame and stream of the frame network (two convs of
    width 3, two dense layers) and of the two condition projections."""
    nc, nin = s["cond_size"], s["nb_features"] + s["embed_pitch_size"]
    na, nb = s["gru_a_units"], s["gru_b_units"]
    return 2 * (3 * nin * nc + 3 * nc * nc + 2 * nc * nc
                + nc * 3 * na + nc * 3 * nb)


def plc_flops(p: Dict[str, int], nb_features: int) -> int:
    """Operations per frame and stream of one PLC network step: a dense
    layer from the 57 inputs, two GRUs, the output layer."""
    d, g = p["dense_size"], p["gru_size"]
    n_in = 2 * 18 + nb_features + 1
    return 2 * (n_in * d + d * 3 * g + g * 3 * g + 2 * g * 3 * g
                + g * nb_features)


def sample_loop_work(s: Dict[str, int], streams: int, frames: int
                     ) -> Dict[str, float]:
    """Operations and bytes of `frames` frames of the sample loop on
    `streams` streams: each input byte once (the tables and weights, the
    per-frame conditions and LPC, the state) and each output byte once (the
    samples, the state)."""
    na, nb, lv = s["gru_a_units"], s["gru_b_units"], s["pcm_levels"]
    order, fs = s["lpc_order"], s["frame_size"]
    weights = (3 * lv * 3 * na           # the three embedding tables
               + na * 3 * na + 3 * na    # GRU-A recurrent, its bias
               + na * 3 * nb + 3 * nb    # GRU-B input from GRU-A, bias
               + nb * 3 * nb + 3 * nb    # GRU-B recurrent, bias
               + 2 * nb * lv + 4 * lv)   # dual FC: kernels, biases, factors
    conds = streams * frames * (3 * na + 3 * nb + order)
    state = streams * (na + nb + order + 1 + 1 + 4 * 2)   # rng: 4 x int64
    out = streams * frames * fs
    return {"flops": float(sample_flops(s)) * streams * frames * fs,
            "bytes": float(F32 * (weights + conds + 2 * state + out))}


def least_seconds(work: Dict[str, float]) -> Dict[str, float]:
    """The least time the card could take for `work`, and which bound
    sets it."""
    t_ops = work["flops"] / PEAKS["fp32_flops"]
    t_mem = work["bytes"] / PEAKS["hbm_bytes_per_s"]
    return {"seconds": max(t_ops, t_mem),
            "bound": "operations" if t_ops >= t_mem else "bytes"}
