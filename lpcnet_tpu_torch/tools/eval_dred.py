"""Rate-distortion evaluation of a trained DRED RDO-VAE checkpoint (the
port of tools/eval_dred.py).

For each lambda quantization level, encode held-out features, hard-quantize
the latents through the trained per-level quantizers, decode, and report:
  - feature RMS (cepstra+pitch+corr, 20 dims) of the round trip
  - sq_rate_metric bits/dframe of the rounded symbols (the entropy-model
    rate estimate the reference trains against, rdovae.py:190-207)
against a random-init baseline, for every level (all 16 by default) on
every given source. Writes the table as JSON (the artifact sidecar) and
prints it.

Usage: python -m lpcnet_tpu_torch.tools.eval_dred ckpt.bin out.json \\
           --source holdout=hold.f32 --source speech=sp.f32 \\
           [--levels 0 .. 15] [--holdout-frames 4000] [--device cuda|cpu]
"""
import argparse
import json
import sys

import torch

from ..constants import NB_FEATURES
from ..device import resolve_device


def evaluate(ckpt, sources, levels=tuple(range(16)), holdout_frames=4000,
             device=None, verbose=True):
    """The JSON table of main: sources is [(name, features path)]."""
    from .. import convert
    from ..cli import read_features
    from ..dred import roundtrip
    from ..models import rdovae as rv
    dev = resolve_device(device)
    params, cfg = convert.load_dred(ckpt, dev)
    rnd = convert.to_device(rv.init_params(torch.Generator().manual_seed(99),
                                           cfg), dev)
    table = {"cond_size": cfg.cond_size, "cond_size2": cfg.cond_size2,
             "holdout_frames": holdout_frames, "sources": {}}
    for name, path in sources:
        feats = read_features(path)[:, :NB_FEATURES]
        T = min(holdout_frames, feats.shape[0]) // 8 * 8
        fj = torch.as_tensor(feats[-T:][None], device=dev)   # tail = holdout
        rows = {}
        for lv in levels:
            rms, bits = roundtrip(params, cfg, fj, lv)
            rrms, rbits = roundtrip(rnd, cfg, fj, lv)
            rows[str(lv)] = {
                "rms": round(rms, 4), "bits_per_dframe": round(bits, 1),
                "rand_rms": round(rrms, 4),
                "rand_bits_per_dframe": round(rbits, 1)}
            if verbose:
                print(f"{name} q{lv}: rms {rms:.4f} @ {bits:.1f} bits/dframe "
                      f"(random init: {rrms:.4f} @ {rbits:.1f})")
        b = [rows[str(lv)]["bits_per_dframe"] for lv in levels]
        rows["rate_span"] = round(max(b) / max(min(b), 1e-9), 2)
        table["sources"][name] = {"frames": int(T), "levels": rows}
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("out_json")
    ap.add_argument("--source", action="append", required=True,
                    help="name=features.f32 (repeatable)")
    ap.add_argument("--levels", type=int, nargs="+",
                    default=list(range(16)))
    ap.add_argument("--holdout-frames", type=int, default=4000,
                    help="use the TAIL this many frames of each source")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    table = evaluate(args.ckpt, [s.split("=", 1) for s in args.source],
                     args.levels, args.holdout_frames, args.device)
    with open(args.out_json, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {args.out_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
