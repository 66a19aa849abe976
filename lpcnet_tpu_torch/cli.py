"""Command line of the PyTorch/CUDA port (the `synthesis` subcommand of
lpcnet_tpu/cli.py, reference lpcnet_demo -synthesis).

    python -m lpcnet_tpu_torch synthesis feats.f32 out.pcm [--device cpu]

Feature files are float32 frames of 36; output is 16-bit little-endian PCM
at 16 kHz. Omitted --weights loads examples/speech_lpcnet_params.bin. The
default device is the card.
"""
import argparse
import sys
import time

import numpy as np
import torch

from .constants import FRAME_SIZE, NB_TOTAL_FEATURES

CHUNK_FRAMES = 64          # frames per synthesize call


def read_features(path: str, width: int = NB_TOTAL_FEATURES) -> np.ndarray:
    x = np.fromfile(path, np.float32)
    if x.size % width:
        raise ValueError(f"{path}: {x.size} floats is not a multiple of "
                         f"{width}")
    return x.reshape(-1, width)


def write_pcm(path: str, pcm: np.ndarray) -> None:
    np.clip(np.asarray(pcm), -32767, 32767).astype(np.int16).tofile(path)


def cmd_synthesis(args) -> int:
    """Feature frames -> PCM, one stream, CHUNK_FRAMES frames per call."""
    from . import convert
    from .vocoder import Synthesizer
    feats = read_features(args.input)
    params = convert.load_lpcnet(args.weights, device=args.device)
    voc = Synthesizer(params=params, device=args.device)
    state = voc.reset(1)
    outs = []
    t_synth = 0.0
    for t0 in range(0, feats.shape[0], CHUNK_FRAMES):
        t = time.perf_counter()
        state, pcm = voc.synthesize(state, feats[None, t0:t0 + CHUNK_FRAMES])
        if voc.device.type == "cuda":
            torch.cuda.synchronize(voc.device)
        t_synth += time.perf_counter() - t
        outs.append(pcm[0].cpu().numpy())
    pcm = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    write_pcm(args.output, pcm)
    rt = (feats.shape[0] * FRAME_SIZE / 16000.0) / max(t_synth, 1e-9)
    print(f"wrote {len(pcm)} samples -> {args.output} "
          f"({rt:.2f}x realtime single-stream on {voc.device})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lpcnet_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("synthesis", help="feature frames -> PCM")
    p.add_argument("input", help="float32 feature file (36 per frame)")
    p.add_argument("output", help="s16le PCM output")
    p.add_argument("--weights", default=None,
                   help="save_params checkpoint (default: shipped vocoder)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.set_defaults(fn=cmd_synthesis)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
