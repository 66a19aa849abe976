"""Fit the Pade (rational) tanh approximation coefficients (the port of
tools/fit_pade.py; reference training_tf2/pade.py:1-107).

The C inference kernels approximate tanh as

    tanh(x) ~= clip(x * (a0 + a1 x^2 + a2 x^4) / (b0 + b1 x^2 + b2 x^4), +-1)

(the AVX/NEON tanh_approx polynomials, src/vec_avx.h:552-616). The
reference derives (a, b) with a staged fit: plain MSE first, then losses
that weight the MAX squared error progressively harder. This tool runs that
derivation with autograd and Adam (b1 = b2 = 0.9, float32): full-grid
batches, the same [945,105,1]/[945,420,15] Taylor seed (the exact Pade
[5/4] expansion of tanh), the same mean->max loss schedule; it writes the
fitted coefficients as JSON.

Usage:
    python -m lpcnet_tpu_torch.tools.fit_pade [--out pade_tanh.json]
        [--steps 20000] [--device cuda|cpu]

Prints per-stage max/mean |error| on the fit grid; the reference's
committed constants reach ~6e-4 max error on [-10, 10].
"""
import argparse
import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..utils import graphs

# the reference's schedule: (mean weight, max weight, learning rate); pure
# MSE, then 1/0.1/0.01 mean weight with unit max weight (pade.py:100-113)
STAGES = ((1.0, 0.0, None), (1.0, 1.0, 1e-3), (0.1, 1.0, 1e-4),
          (0.01, 1.0, 1e-5))


def grid(device):
    """(x, tanh x, basis [1, x^2, x^4]) on [-10, 10) by 0.01."""
    x = torch.as_tensor(np.arange(-10.0, 10.0, 0.01, dtype=np.float32),
                        device=device)
    x2 = x * x
    return x, torch.tanh(x), torch.stack([torch.ones_like(x2), x2, x2 * x2],
                                         dim=-1)


def seed_params(device):
    """The Taylor-series Pade [5/4] seed (pade.py num_init/den_init)."""
    return {"num": torch.tensor([945.0, 105.0, 1.0], device=device),
            "den": torch.tensor([945.0, 420.0, 15.0], device=device)}


def predict(p, x, basis):
    from ..ops import ties
    return ties.clip(x * (basis @ p["num"]) / (basis @ p["den"]), -1.0, 1.0)


def loss_fn(p, x, y, basis, mean_w: float, max_w: float):
    e2 = torch.square(predict(p, x, basis) - y)
    return mean_w * torch.mean(e2) + max_w * torch.amax(e2)


def _fit_step(params, state, x, y, basis, mean_w: float, max_w: float,
              opt):
    """One Adam step of the stage's loss. Returns (params, state)."""
    from ..training.optim import value_and_grad
    _, g = value_and_grad(
        lambda p: (loss_fn(p, x, y, basis, mean_w, max_w), {}), params)
    return opt.apply(params, g, state)


# the counterpart of the JAX tool's jitted step (tools/fit_pade.py:60):
# the stage's weights and its optimizer are static leaves, so each stage
# is a signature; on the card its first step runs eagerly, the second is
# captured, and the others replay it
fit_step = graphs.jit(_fit_step, "fit_pade.step")


def fit(steps_per_stage: int = 20000, lr: float = 0.05, verbose: bool = True,
        device=None):
    """The staged fit from the seed. Returns ({num, den} as lists, max
    |error|, mean |error|) on the grid."""
    from ..training.optim import ScheduledAdam
    dev = resolve_device(device)
    x, y, basis = grid(dev)
    params = seed_params(dev)
    err = None
    for mean_w, max_w, slr in STAGES:
        opt = ScheduledAdam(lr=lr if slr is None else slr, b1=0.9, b2=0.9)
        state = opt.init(params)
        for _ in range(steps_per_stage):
            params, state = fit_step(params, state, x, y, basis, mean_w,
                                     max_w, opt)
        with torch.no_grad():
            err = (predict(params, x, basis) - y).abs().cpu().numpy()
        if verbose:
            print(f"stage mean_w={mean_w} max_w={max_w}: "
                  f"max|err| {err.max():.3e}, mean|err| {err.mean():.3e}",
                  file=sys.stderr)
    return ({k: v.cpu().numpy().tolist() for k, v in params.items()},
            float(err.max()), float(err.mean()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="pade_tanh.json")
    ap.add_argument("--steps", type=int, default=20000,
                    help="optimizer steps per loss stage")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    coeffs, emax, emean = fit(args.steps, device=args.device)
    result = {"form": "tanh(x) ~= clip(x*(n0+n1*x^2+n2*x^4)"
                      "/(d0+d1*x^2+d2*x^4), -1, 1)",
              "num": coeffs["num"], "den": coeffs["den"],
              "max_abs_err": emax, "mean_abs_err": emean,
              "grid": "[-10, 10) step 0.01"}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in
                      ("num", "den", "max_abs_err")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
