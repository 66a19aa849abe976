"""Command line of the PyTorch/CUDA port (the `synthesis` and `plc`
subcommands of lpcnet_tpu/cli.py, reference lpcnet_demo -synthesis and
-plc_file).

    python -m lpcnet_tpu_torch synthesis feats.f32 out.pcm [--streaming |
        --temperature] [--device cpu]
    python -m lpcnet_tpu_torch plc <loss> in.pcm out.pcm [--options causal|
        causal_dc|noncausal|noncausal_dc|strict] [--device cpu]

Feature files are float32 frames of 36; audio is 16-bit little-endian PCM
at 16 kHz (headerless, or .wav on input). Omitted --weights and
--plc-weights load examples/speech_lpcnet_params.bin and
examples/speech_plc_params.bin. The default device is the card.
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


def read_pcm(path: str) -> np.ndarray:
    """Read headerless s16le (or .wav) as float32 samples."""
    if path.endswith(".wav"):
        import wave
        with wave.open(path, "rb") as w:
            if w.getsampwidth() != 2 or w.getnchannels() != 1:
                raise ValueError(f"{path}: expected 16-bit mono wav")
            data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        return data.astype(np.float32)
    return np.fromfile(path, np.int16).astype(np.float32)


def write_pcm(path: str, pcm: np.ndarray) -> None:
    np.clip(np.asarray(pcm), -32767, 32767).astype(np.int16).tofile(path)


def cmd_synthesis(args) -> int:
    """Feature frames -> PCM, one stream, CHUNK_FRAMES frames per call."""
    from . import convert
    from .vocoder import Synthesizer
    if args.temperature and args.streaming:
        print("error: --temperature needs the batched path (no --streaming)",
              file=sys.stderr)
        return 1
    feats = read_features(args.input)
    params = convert.load_lpcnet(args.weights, device=args.device)
    voc = Synthesizer(params=params, device=args.device)
    if args.streaming:
        state, synth = voc.reset_streaming(1), voc.synthesize_streaming
    elif args.temperature:
        state, synth = voc.reset(1), voc.synthesize_temperature
    else:
        state, synth = voc.reset(1), voc.synthesize
    outs = []
    t_synth = 0.0
    for t0 in range(0, feats.shape[0], CHUNK_FRAMES):
        t = time.perf_counter()
        state, pcm = synth(state, feats[None, t0:t0 + CHUNK_FRAMES])
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


PLC_MODES = ("causal", "causal_dc", "noncausal", "noncausal_dc", "strict")


def _read_loss_flags(spec: str, n_packets: int, seed: int = 0) -> np.ndarray:
    """Loss flags, one per 20-ms packet, 1 = lost. spec is a percentage
    (random losses) or a trace file (lpcnet_demo.c:231-243)."""
    try:
        pct = float(spec)
    except ValueError:
        flags = np.loadtxt(spec, dtype=np.int64).reshape(-1)
        # a short trace keeps its last value after its end, as the
        # reference's fscanf loop does (lpcnet_demo.c:236)
        pad = np.full(max(n_packets - len(flags), 0),
                      flags[-1] if len(flags) else 0, np.int64)
        return np.concatenate([flags, pad])[:n_packets].astype(np.int32)
    rs = np.random.RandomState(seed)
    return (rs.uniform(0, 100, n_packets) < pct).astype(np.int32)


def cmd_plc(args) -> int:
    """Concealment over a PCM stream with a loss pattern
    (lpcnet_demo -plc_file, src/lpcnet_demo.c:220-249)."""
    from . import convert
    from .constants import TRAINING_OFFSET
    from .plc import (NonCausalPLCEngine, PLCEngine, PLCOptions,
                      StrictCausalPLCEngine)
    pcm = read_pcm(args.input)
    n_fr = len(pcm) // FRAME_SIZE // 2 * 2
    pcm = pcm[:n_fr * FRAME_SIZE]
    flags = _read_loss_flags(args.loss, n_fr // 2, args.seed)
    noncausal = "noncausal" in args.options
    cls = (NonCausalPLCEngine if noncausal
           else StrictCausalPLCEngine if args.options == "strict"
           else PLCEngine)
    engine = cls(
        convert.load_lpcnet(args.weights, device=args.device),
        convert.load_plc(args.plc_weights, device=args.device),
        options=PLCOptions(remove_dc="dc" in args.options),
        device=args.device)
    state = engine.init_state(1)
    outs = []
    for f in range(n_fr):
        state, out = engine.step(
            state, pcm[None, f * FRAME_SIZE:(f + 1) * FRAME_SIZE],
            [bool(flags[f // 2])])
        outs.append(out[0].cpu().numpy())
    if noncausal and outs:
        # sample-align output with input: drop the 80-sample engine delay
        # and flush the delay line with one extra conceal step, as the
        # reference demo does (lpcnet_demo.c:226 skip=extra=80, :245-248)
        _, out = engine.step(state, np.zeros((1, FRAME_SIZE), np.float32),
                             [True])
        outs.append(out[0, :TRAINING_OFFSET].cpu().numpy())
        outs[0] = outs[0][TRAINING_OFFSET:]
    write_pcm(args.output,
              np.concatenate(outs) if outs else np.zeros(0, np.float32))
    print(f"processed {n_fr} frames, {int(flags.sum())} lost packets "
          f"-> {args.output} (on {engine.device})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lpcnet_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("synthesis", help="feature frames -> PCM")
    p.add_argument("input", help="float32 feature file (36 per frame)")
    p.add_argument("output", help="s16le PCM output")
    p.add_argument("--weights", default=None,
                   help="save_params checkpoint (default: shipped vocoder)")
    p.add_argument("--streaming", action="store_true",
                   help="reference-exact streaming engine (causal convs, "
                   "FEATURES_DELAY warm-up silence)")
    p.add_argument("--temperature", action="store_true",
                   help="temperature/pdf-floor sampling (plain loop; not "
                   "with --streaming)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.set_defaults(fn=cmd_synthesis)
    p = sub.add_parser("plc", help="conceal lost packets in a PCM stream")
    p.add_argument("loss", help="loss percentage, or a trace file with one "
                   "0/1 flag per 20-ms packet")
    p.add_argument("input", help="s16le PCM (or .wav) input")
    p.add_argument("output", help="s16le PCM output")
    p.add_argument("--options", default="causal", choices=PLC_MODES,
                   help="the reference demo's 4 PLC methods "
                   "(lpcnet_demo.c:120-127) plus strict = the replica of "
                   "the reference's default causal engine")
    p.add_argument("--weights", default=None,
                   help="vocoder checkpoint (default: shipped vocoder)")
    p.add_argument("--plc-weights", default=None,
                   help="PLC checkpoint (default: shipped PLC network)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random loss pattern")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.set_defaults(fn=cmd_plc)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
