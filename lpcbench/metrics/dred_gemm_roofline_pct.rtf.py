"""dred_gemm_roofline_pct.rtf: the RDO-VAE encoder's products' least time
on the card (their operations at the float32 peak; lpcbench/
rdovae_flops.py) over the traced time of the call's GEMM kernels
(cuBLAS's, by name), percent."""
from lpcbench import rdovae_flops

LAYER = "kernel"


def read(run):
    return rdovae_flops.gemm_roofline_pct(run)
