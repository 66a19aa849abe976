"""Concealment-quality evaluation of a PLC checkpoint on clean features
(the port of tools/eval_plc.py).

Simulates packet losses on a clean [burg36|feat36] stream (dump-data
btest format; 20-ms packets = 2 frames per loss decision,
lpcnet_demo.c:235), feeds the net the masked stream as the training loader
does (plc_loader.py:56-89: inputs zeroed where lost, received flag), and
reports the mean L1 over the 20 predicted features ON LOST FRAMES against
two baselines: predict-zero and a random-init net.

Usage: python -m lpcnet_tpu_torch.tools.eval_plc ckpt.bin btest.f32
       [loss_rate=0.25] [seed] [--device cuda|cpu]
"""
import argparse
import sys

import numpy as np
import torch

from ..constants import NB_BANDS, NB_FEATURES, NB_TOTAL_FEATURES
from ..device import resolve_device
from ..utils import graphs


def masked_inputs(data: np.ndarray, loss_rate: float, seed: int):
    """The net's inputs (1, T, 57), the true features (T, 20) and the lost
    frames (T,) of btest frames `data` (T, 72), the loss flags drawn from
    RandomState(seed) per 20-ms packet."""
    burg = data[:, :2 * NB_BANDS]
    feat = data[:, 2 * NB_BANDS:2 * NB_BANDS + NB_FEATURES]
    clean = np.concatenate([burg, feat], axis=-1)     # (T, 56)
    T = len(clean)
    rs = np.random.RandomState(seed)
    pkt = (rs.uniform(size=(T + 1) // 2) >= loss_rate).astype(np.float32)
    received = np.repeat(pkt, 2)[:T]
    if received.min() > 0:                            # ensure some losses
        received[T // 2:T // 2 + 2] = 0.0
    rec = received[None, :, None]
    inputs = np.concatenate([clean[None] * rec, rec], axis=-1)
    return inputs, feat, received < 0.5


@torch.no_grad()
def _forward(params, x):
    from ..models import plc as plc_model
    return plc_model.forward_sequence(params, x)


# the JAX tool's jitted forward (tools/eval_plc.py:58): called for the
# trained and the random weights on one input, so on the card the second
# call captures it when the two trees have one signature
forward = graphs.jit(_forward, "eval_plc.forward")


def lost_l1(params, inputs, feat, lost, device) -> float:
    """Mean |prediction - truth| on the lost frames, the net on device."""
    from .. import convert
    pred = forward(convert.to_device(params, device),
                   torch.as_tensor(inputs, device=device))[0].cpu().numpy()
    return float(np.abs(pred[lost] - feat[lost]).mean())


def evaluate(ckpt, feat_path, loss_rate=0.25, seed=0, device=None):
    """(lost frames, frames, {trained, predict-zero, random init: L1})."""
    from .. import convert
    from ..models import plc as plc_model
    dev = resolve_device(device)
    width = 2 * NB_BANDS + NB_TOTAL_FEATURES          # 72 (btest)
    raw = np.fromfile(feat_path, np.float32)
    if raw.size % width:
        raise ValueError(f"{feat_path}: expected dump-data btest "
                         f"{width}-wide frames")
    inputs, feat, lost = masked_inputs(raw.reshape(-1, width), loss_rate,
                                       seed)
    results = {
        "trained": lost_l1(convert.load_plc(ckpt, dev), inputs, feat, lost,
                           dev),
        "predict-zero": float(np.abs(feat[lost]).mean()),
        "random init": lost_l1(plc_model.init_params(
            torch.Generator().manual_seed(7)), inputs, feat, lost, dev)}
    return int(lost.sum()), len(feat), results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("btest")
    ap.add_argument("loss_rate", nargs="?", type=float, default=0.25)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n_lost, T, r = evaluate(args.ckpt, args.btest, args.loss_rate,
                            args.seed, args.device)
    print(f"lost frames: {n_lost}/{T} at rate {args.loss_rate}")
    print(f"feature L1 on lost frames: trained {r['trained']:.3f}  "
          f"predict-zero {r['predict-zero']:.3f}  random-init "
          f"{r['random init']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
