"""Operations and bytes of the RDO-VAE encoder's products (DRED), counted
from the configuration's shapes by the model's arithmetic, never by one
implementation's.

Per stream and dframe (two pairs of feature frames), as the reference's
C encoder computes them (src/dred_rdovae_enc.c:38-95) at the pairs a
dframe keeps: the stack twice (dense1 from the 40 inputs, three GRUs'
input and recurrent products, dense3, dense5, dense7, dense8), the causal
conv's four taps once (the latent of the dframe's second pair) and the
state head once (gdense1, gdense2). At RDOVAEConfig() (GRUs of 1024,
denses of 256) that is 2 x 14,428,160 + 1,884,160 + 756,736 = 31,497,216
multiply-adds. Gates, activations, PVQ and the payload's quantization
are elementwise and not counted.

The products run as cuBLAS's float32 GEMMs (TF32 off): GEMM_KERNELS are
the substrings of their kernel names in a device trace.
"""
from typing import Dict, Iterator, Optional, Tuple

from lpcbench import flops

# names of cuBLAS's GEMM and GEMV kernels and of its split-K reduction,
# matched in lower case
GEMM_KERNELS = ("gemm", "gemv", "splitkreduce")


def _products(r: Dict[str, int]) -> Iterator[Tuple[int, int, int]]:
    """(rows per stream and dframe, K, N) of each product."""
    nf, c, c2 = r["nb_features"], r["cond_size"], r["cond_size2"]
    concat = 3 * c2 + 5 * c
    yield 2, 2 * nf, c2                          # dense1
    for _ in range(3):
        yield 2, c2, 3 * c                       # GRU input
        yield 2, c, 3 * c                        # GRU recurrent
    yield 2, c, c2                               # dense3
    yield 2, c, c2                               # dense5
    yield 2, c, c                                # dense7
    yield 2, c, c                                # dense8
    yield 1, 4 * concat, r["nb_latents"]         # conv, four taps
    yield 1, concat, 128                         # gdense1
    yield 1, 128, r["state_dim"]                 # gdense2


def dframe_macs(r: Dict[str, int]) -> int:
    """Multiply-adds per stream and dframe."""
    return sum(m * k * n for m, k, n in _products(r))


def encoder_work(r: Dict[str, int], streams: int, dframes: int
                 ) -> Dict[str, float]:
    """Operations and bytes of `dframes` dframes of `streams` streams:
    each weight byte once, and each product's input and output bytes
    once."""
    weights = sum(k * n for _, k, n in _products(r))
    acts = sum(m * (k + n) for m, k, n in _products(r))
    return {"flops": 2.0 * dframe_macs(r) * streams * dframes,
            "bytes": float(flops.F32 * (weights
                                        + acts * streams * dframes))}


def gemm_roofline_pct(run) -> Optional[float]:
    """The products' least time on the card (operations at the float32
    peak, or bytes at HBM bandwidth, whichever is larger) over the traced
    time of the GEMM kernels, in percent; None without a trace, a GEMM
    record or the call's work."""
    work = run.call_work.get("dred_gemm")
    if run.trace is None or work is None:
        return None
    t = run.trace.busy_us(lambda n: any(k in n.lower()
                                        for k in GEMM_KERNELS)) * 1e-6
    if t <= 0.0:
        return None
    least = flops.least_seconds(work)["seconds"]
    return 100.0 * least * run.traced_calls / t
