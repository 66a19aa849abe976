"""Train and evaluate the codec codebooks (examples/codec_codebooks.bin);
the port of tools/train_codebooks.py.

The reference's codebook flow (download_model.sh fetches ceps_codebooks.c,
trained by src/ceps_vq_train.c on a speech corpus) on the port: a feature
corpus is built from the in-repo speech sample (tests/golden/speech.s16,
2 s) through the dump_data-style augmentation (random biquads, gains and
noise per pass: data.augment over the native library), codebooks are
trained with codec/vq_train.py, and codec quality is measured on held-out
material:
  * stage RMS: cepstrum RMS error after VQ stages 1/2/3 (what
    ceps_vq_train.c prints at :497,513,529) on held-out features
  * end-to-end codec distortion: encode/decode round trip, RMS over the
    18-dim cepstra of all 4 frames against the unquantized features
  * the same with random placeholder codebooks, to show the margin

Usage:
    python -m lpcnet_tpu_torch.tools.train_codebooks [--passes 500]
        [--out examples/codec_codebooks.bin] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..constants import FRAME_SIZE, NB_BANDS
from ..device import resolve_device
from ..utils import graphs

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    os.pardir)
GOLDEN = os.path.join(REPO, "tests", "golden", "speech.s16")


@torch.no_grad()
def _feats_of(x: torch.Tensor) -> torch.Tensor:
    """Superframe features (N, T, 36) of N augmented passes (N, S): their
    de-emphasis and one compute_features call from a fresh state."""
    from .. import features as F
    from ..ops import dsp
    z, _ = dsp.deemphasis_scan(x, x.new_zeros(x.shape[0]))
    return F.compute_features(F.init_state(x.shape[0], x.device), z)[1]


# the JAX tool's jitted feats_of (tools/train_codebooks.py:51): every full
# batch of passes has one shape, so on the card the second batch captures
# it and the later ones replay
feats_of = graphs.jit(_feats_of, "train_codebooks.feats_of")


def build_corpus(pcm: np.ndarray, passes: int, seed0: int, device,
                 batch: int = 16) -> np.ndarray:
    """Features of `passes` differently-augmented copies of pcm, extracted
    `batch` passes at a time. Returns (passes*T, 36)."""
    from .. import data as D
    S = len(pcm) // (4 * FRAME_SIZE) * (4 * FRAME_SIZE)
    out = []
    for b0 in range(0, passes, batch):
        n_real = min(passes, b0 + batch) - b0
        xs = [D.augment(pcm[:S], seed=seed0 + b0 + p)[0][:S]
              for p in range(n_real)]
        f = feats_of(torch.as_tensor(np.stack(xs), device=device))
        out.append(f.cpu().numpy().reshape(-1, f.shape[-1]))
        print(f"  corpus: {b0 + n_real}/{passes} passes", flush=True)
    return np.concatenate(out)


@torch.no_grad()
def stage_rms(feats: np.ndarray, cbs, device) -> dict:
    """Cepstrum RMS error after each VQ stage (ceps_vq_train.c prints
    these at :497,:513,:529; divides by the FULL ndim=18)."""
    from ..codec.vq_train import _assign_chunked
    r = torch.as_tensor(feats[:, 1:18], device=device)
    out = {}
    for i, key in enumerate(("cb1", "cb2", "cb3"), 1):
        cb = torch.as_tensor(cbs[key], device=device)
        r = r - cb[_assign_chunked(r, cb)]
        out[f"stage{i}_rms"] = float(torch.sqrt(torch.mean(
            torch.sum(r * r, -1) / 18.0)))
    return out


@torch.no_grad()
def codec_rms(pcm: np.ndarray, cbs, device) -> float:
    """End-to-end codec distortion: encode/decode round trip on audio,
    RMS over all 4 frames' 18-dim cepstra against unquantized features.
    The features are one call of the feature step, then one call of the
    encode and decode steps per superframe (data.codec_step: on the card
    the second superframe captures them and the others replay)."""
    from .. import features as F
    from ..data import codec_step, feature_step
    n_sf = len(pcm) // 640
    _, feats, sps = feature_step(True)(
        F.init_state(1, device),
        torch.as_tensor(pcm[None, :n_sf * 640].astype(np.float32),
                        device=device))
    cbs = {k: torch.as_tensor(v, device=device) for k, v in cbs.items()}
    enc = codec_step("encode_superframe", cbs)
    dec = codec_step("decode_packet", cbs)
    vq_mem = torch.zeros((1, NB_BANDS), device=device)
    dec_mem = torch.zeros((1, NB_BANDS), device=device)
    err, n = 0.0, 0
    for g in range(n_sf):
        raw4 = feats[:, 4 * g:4 * (g + 1)]
        buf, _, vq_mem = enc(raw4, vq_mem, sps[g])
        rec4, dec_mem = dec(buf, dec_mem)
        d = (rec4[0, :, :NB_BANDS] - raw4[0, :, :NB_BANDS]).cpu().numpy()
        err += float((d * d).sum())
        n += 4 * NB_BANDS
    return float(np.sqrt(err / n))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=500)
    ap.add_argument("--features", default=None,
                    help="prebuilt 36-dim feature corpus (.f32, e.g. from "
                         "dump-data train) to train on instead of building "
                         "--passes augmentation passes here")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--final-iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        REPO, "examples", "codec_codebooks.bin"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..codec import codec, vq_train
    from ..utils import weights_io
    dev = resolve_device(args.device)
    pcm = np.fromfile(GOLDEN, np.int16).astype(np.float32)

    t0 = time.time()
    if args.features:
        train_feats = np.fromfile(args.features, np.float32).reshape(-1, 36)
        print(f"loaded corpus: {args.features} ({len(train_feats)} frames)")
    else:
        print(f"building corpus: {args.passes} augmentation passes ...")
        train_feats = build_corpus(pcm, args.passes, args.seed, dev)
    # held-out: 8 unseen augmentation seeds
    held = build_corpus(pcm, 8, args.seed + 100003, dev)
    print(f"corpus: train {train_feats.shape}, held-out {held.shape} "
          f"({time.time() - t0:.0f}s)")

    t0 = time.time()
    cbs = vq_train.train_codec_codebooks(
        torch.Generator(device=dev).manual_seed(args.seed),
        torch.as_tensor(train_feats, device=dev), iters=args.iters,
        final_iters=args.final_iters)
    cbs = {k: v.cpu().numpy() for k, v in cbs.items()}
    print(f"trained in {time.time() - t0:.0f}s")

    report = {"passes": (args.features or args.passes),
              "train_frames": int(len(train_feats)),
              "held_frames": int(len(held))}
    report.update({f"held_{k}": v
                   for k, v in stage_rms(held, cbs, dev).items()})
    report["held_codec_rms"] = codec_rms(pcm, cbs, dev)
    rand = {k: v.cpu().numpy() for k, v in codec.default_codebooks(
        torch.Generator().manual_seed(0)).items()}
    report.update({f"rand_{k}": v
                   for k, v in stage_rms(held, rand, dev).items()})
    report["rand_codec_rms"] = codec_rms(pcm, rand, dev)

    weights_io.save_params(args.out, cbs)
    with open(args.out + ".json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
