"""Command line of the PyTorch/CUDA port: the inference subcommands of
lpcnet_tpu/cli.py (reference lpcnet_demo -features, -synthesis, -encode,
-decode, -plc_file and -addlpc, dump_weights_blob, and the DRED and PLC
scripts of training_tf2/).

    python -m lpcnet_tpu_torch features in.pcm feats.f32 [--quantize-pitch]
    python -m lpcnet_tpu_torch synthesis feats.f32 out.pcm [--streaming |
        --temperature]
    python -m lpcnet_tpu_torch encode in.pcm packets.bin [--codebooks F]
    python -m lpcnet_tpu_torch decode packets.bin out.pcm [--codebooks F]
        [--weights F]
    python -m lpcnet_tpu_torch plc <loss> in.pcm out.pcm [--options causal|
        causal_dc|noncausal|noncausal_dc|strict]
    python -m lpcnet_tpu_torch plc-test in.f32 out.f32 [--weights F]
    python -m lpcnet_tpu_torch addlpc feats.f32 out.f32
    python -m lpcnet_tpu_torch dump-weights-blob out.bin lpcnet=ck.bin ...
    python -m lpcnet_tpu_torch rdovae-encode feats.f32 latents.s16 [--quant Q]
    python -m lpcnet_tpu_torch rdovae-decode latents.s16 feats.f32
        [--quant Q]
    python -m lpcnet_tpu_torch fec-encode in.pcm out.fec
        [--num-redundancy N] [--packets-per-fec P]

Every command but dump-weights-blob (numpy only) takes --device (default:
the card; --device cpu runs the plain PyTorch paths). Feature files are
float32 frames of 36; audio is 16-bit little-endian PCM at 16 kHz
(headerless, or .wav on input); a packet is 8 bytes per 40 ms (1.6 kb/s).
Omitted --weights, --plc-weights and --codebooks load
examples/speech_lpcnet_params.bin, examples/speech_plc_params.bin (the PLC
network, also plc-test's --weights), examples/speech_dred_params.bin (the
DRED commands) and examples/codec_codebooks.bin.
`synthesis` and `decode` read LPCNET_KERNEL_TABLES (f32, the default, or
bf16: the frame kernel's embedding tables in bfloat16), as the JAX
package's Synthesizer does.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

from .constants import (FRAME_SIZE, LPCNET_COMPRESSED_SIZE,
                        LPCNET_PACKET_SAMPLES, NB_BANDS, NB_FEATURES,
                        NB_TOTAL_FEATURES)

CHUNK_FRAMES = 64          # frames per feature-extraction or synthesize call
DEFAULT_CODEBOOKS = os.path.join(os.path.dirname(__file__), os.pardir,
                                 "examples", "codec_codebooks.bin")


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


def _pad_to_chunks(pcm: np.ndarray, frames: int,
                   chunk_frames: int = CHUNK_FRAMES) -> np.ndarray:
    """The first `frames` frames of a sample stream, zero-padded to whole
    chunks of chunk_frames frames, so that every feature-extraction call
    has the same shape, as the JAX command's fixed jit shapes do
    (lpcnet_tpu/cli.py:159-170): its packets are those of the JAX
    command's chunking."""
    total = -(-frames // chunk_frames) * chunk_frames * FRAME_SIZE
    out = np.zeros(total, np.float32)
    out[:frames * FRAME_SIZE] = pcm[:frames * FRAME_SIZE]
    return out


def _kernel_tables() -> str:
    """The frame kernel's table type from LPCNET_KERNEL_TABLES: 'bf16' for
    bf16, else 'f32' (the JAX package's reading, lpcnet_tpu/vocoder.py)."""
    return "bf16" if os.environ.get("LPCNET_KERNEL_TABLES") == "bf16" \
        else "f32"


def superframe_features(pcm: torch.Tensor, frames: int,
                        quantize_pitch: bool = False) -> torch.Tensor:
    """Superframe features of (B, samples) pcm holding whole chunks
    (_pad_to_chunks), CHUNK_FRAMES frames per compute_features call.
    Returns the first `frames` frames, (B, frames, 36)."""
    from . import features as F
    state = F.init_state(pcm.shape[0], pcm.device)
    out = []
    step = CHUNK_FRAMES * FRAME_SIZE
    for s0 in range(0, pcm.shape[1], step):
        state, feats, _ = F.compute_features(
            state, pcm[:, s0:s0 + step], quantize_pitch=quantize_pitch)
        out.append(feats)
    return torch.cat(out, dim=1)[:, :frames] if out else pcm.new_zeros(
        (pcm.shape[0], 0, NB_TOTAL_FEATURES))


def cmd_features(args) -> int:
    """PCM -> float32 feature frames (lpcnet_demo -features): superframe
    features of whole superframes, CHUNK_FRAMES frames per call."""
    from .device import resolve_device
    dev = resolve_device(args.device)
    pcm = read_pcm(args.input)
    T = len(pcm) // FRAME_SIZE // 4 * 4
    pcm = torch.as_tensor(_pad_to_chunks(pcm, T), device=dev)
    allf = superframe_features(pcm[None], T, args.quantize_pitch)[0]
    allf.cpu().numpy().astype(np.float32).tofile(args.output)
    print(f"wrote {allf.shape[0]} frames x {allf.shape[1]} -> {args.output} "
          f"(on {dev})")
    return 0


def load_codebooks(path, device) -> dict:
    """Codec codebooks on `device`: the --codebooks file, else the shipped
    trained set (examples/codec_codebooks.bin), else random placeholders
    with a loud warning (quantizing through random codebooks is
    meaningless), as lpcnet_tpu/cli.py::_load_codebooks does."""
    from .codec import codec
    from .utils import weights_io
    if path is None:
        if not os.path.exists(DEFAULT_CODEBOOKS):
            print("warning: no trained codec codebooks found "
                  f"({DEFAULT_CODEBOOKS} missing) - using RANDOM "
                  "placeholders; quantized output will be garbage. "
                  "Pass --codebooks.", file=sys.stderr)
            return codec.default_codebooks(torch.Generator().manual_seed(0),
                                           device)
        path = DEFAULT_CODEBOOKS
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in weights_io.load_params(path).items()}


def encode_chunks(cbs, pcm: torch.Tensor, n_sf: int):
    """The encode command's steps on (B, samples) pcm of n_sf whole
    superframes padded to whole chunks (_pad_to_chunks): per chunk of
    CHUNK_FRAMES frames, superframe features with quantized pitch, then
    codec.encode_superframes. Returns (B, n_sf, 8) uint8 packets."""
    from . import features as F
    from .codec import codec
    B = pcm.shape[0]
    state = F.init_state(B, pcm.device)
    vq_mem = torch.zeros((B, NB_BANDS), device=pcm.device)
    group = CHUNK_FRAMES // 4
    bufs = []
    for g0 in range(0, n_sf, group):
        x = pcm[:, g0 * LPCNET_PACKET_SAMPLES:
                (g0 + group) * LPCNET_PACKET_SAMPLES]
        state, feats, sps = F.compute_features(state, x, quantize_pitch=True)
        buf, _, vq_mem = codec.encode_superframes(cbs, feats, vq_mem, sps)
        bufs.append(buf[:, :min(group, n_sf - g0)])
    return torch.cat(bufs, dim=1) if bufs else torch.zeros(
        (B, 0, LPCNET_COMPRESSED_SIZE), dtype=torch.uint8, device=pcm.device)


def cmd_encode(args) -> int:
    """PCM -> 8-byte packets per 40 ms (lpcnet_demo -encode)."""
    from .device import resolve_device
    dev = resolve_device(args.device)
    pcm = read_pcm(args.input)
    n_sf = len(pcm) // LPCNET_PACKET_SAMPLES
    cbs = load_codebooks(args.codebooks, dev)
    x = torch.as_tensor(_pad_to_chunks(pcm, n_sf * 4), device=dev)
    blob = encode_chunks(cbs, x[None], n_sf)[0].cpu().numpy().reshape(-1)
    blob.tofile(args.output)
    print(f"wrote {n_sf} packets ({blob.size} bytes, 1.6 kb/s) "
          f"-> {args.output} (on {dev})")
    return 0


def cmd_decode(args) -> int:
    """8-byte packets -> PCM (lpcnet_demo -decode): the whole packet stream
    decoded at once, then synthesized in CHUNK_FRAMES-frame calls with a
    tail of its natural length (lpcnet_tpu/cli.py:299-341)."""
    from . import convert
    from .codec import codec
    from .vocoder import Synthesizer
    raw = np.fromfile(args.input, np.uint8)
    n_sf = raw.size // LPCNET_COMPRESSED_SIZE
    if n_sf == 0:
        print(f"error: {args.input}: no complete "
              f"{LPCNET_COMPRESSED_SIZE}-byte packets ({raw.size} bytes)",
              file=sys.stderr)
        return 1
    if raw.size % LPCNET_COMPRESSED_SIZE:
        print(f"warning: {args.input}: trailing "
              f"{raw.size % LPCNET_COMPRESSED_SIZE} bytes ignored",
              file=sys.stderr)
    params = convert.load_lpcnet(args.weights, device=args.device)
    voc = Synthesizer(params=params, device=args.device,
                      tables=_kernel_tables())
    cbs = load_codebooks(args.codebooks, voc.device)
    bufs = torch.as_tensor(raw[:n_sf * LPCNET_COMPRESSED_SIZE].reshape(
        1, n_sf, LPCNET_COMPRESSED_SIZE), device=voc.device)
    feats, _ = codec.decode_packets(
        cbs, bufs, torch.zeros((1, NB_BANDS), device=voc.device))
    state = voc.reset(1)
    outs = []
    for t0 in range(0, feats.shape[1], CHUNK_FRAMES):
        state, pcm = voc.synthesize(state, feats[:, t0:t0 + CHUNK_FRAMES])
        outs.append(pcm[0].cpu().numpy())
    pcm = np.concatenate(outs)
    write_pcm(args.output, pcm)
    print(f"wrote {len(pcm)} samples -> {args.output} (on {voc.device})")
    return 0


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
    voc = Synthesizer(params=params, device=args.device,
                      tables=_kernel_tables())
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


def cmd_plc_test(args) -> int:
    """Offline PLC-network test: a feature file with a received column ->
    reconstructed features, out = feat*received + (1-received)*pred.

    The trailing column is 1 where the frame was RECEIVED: it multiplies
    the kept features (training_tf2/test_plc.py:104-117, where it is
    named `lost`)."""
    from . import convert
    from .device import resolve_device
    from .models import plc as plc_model
    dev = resolve_device(args.device)
    width = 2 * NB_BANDS + NB_FEATURES + 1     # burg36 | feat20 | received
    data = read_features(args.input, width)
    params = convert.load_plc(args.weights, device=dev)
    received = data[:, -1:]
    inp = torch.as_tensor(np.concatenate(
        [data[:, :-1] * received, received], axis=-1)[None], device=dev)
    pred = plc_model.forward_sequence(params, inp)[0].cpu().numpy()
    feat = data[:, 2 * NB_BANDS:-1]
    out = feat * received + pred * (1 - received)
    out.astype(np.float32).tofile(args.output)
    print(f"wrote {out.shape[0]} reconstructed frames -> {args.output} "
          f"(on {dev})")
    return 0


def cmd_addlpc(args) -> int:
    """Recompute the LPC tail of a feature file from its cepstra
    (lpcnet_demo -addlpc, src/lpcnet_demo.c:250-259)."""
    from .device import resolve_device
    from .ops import dsp
    dev = resolve_device(args.device)
    feats = read_features(args.input)
    lpc, _ = dsp.lpc_from_cepstrum(torch.as_tensor(feats[:, :NB_BANDS],
                                                   device=dev))
    feats[:, NB_BANDS + 2:] = lpc.cpu().numpy()
    feats.astype(np.float32).tofile(args.output)
    print(f"rewrote LPC for {feats.shape[0]} frames -> {args.output} "
          f"(on {dev})")
    return 0


def cmd_dump_weights_blob(args) -> int:
    """Bundle model checkpoints into one DNNw blob, one family prefix each
    (dump_weights_blob, src/write_lpcnet_weights.c:69-77): the records of
    `prefix=checkpoint` are named prefix[0] + a 4-digit index, in the
    sorted order of the prefixed parameter paths."""
    from . import convert
    from .utils import weights_io
    arrays = {}
    for spec in args.models:
        if "=" not in spec:
            raise ValueError(f"{spec!r}: expected prefix=checkpoint")
        prefix, path = spec.split("=", 1)
        flat = weights_io.flatten(convert.load_model_params(path),
                                  prefix + "/")
        for i, (name, a) in enumerate(sorted(flat.items())):
            arrays[f"{prefix[:1]}{i:04d}"] = (
                a.astype(np.float32) if a.dtype == np.float64 else a)
    weights_io.write_blob(args.output, arrays)
    print(f"wrote {len(arrays)} arrays -> {args.output}")
    return 0


def _dred_codec(args, dred_cfg=None):
    """A DREDCodec on --device with the --weights RDO-VAE."""
    from . import convert
    from .dred import DREDCodec, DREDConfig
    from .device import resolve_device
    dev = resolve_device(args.device)
    params, cfg = convert.load_dred(args.weights, device=dev)
    return DREDCodec(params, cfg, dred_cfg or DREDConfig(), device=dev)


def cmd_rdovae_encode(args) -> int:
    """Features -> quantized latents (encode_rdovae.py): int16 symbols
    (S, 80), one row per 20-ms dframe, and the float32 PVQ resume states
    (S, 24) in OUTPUT.state."""
    from .models import rdovae as rv
    feats = read_features(args.input)[:, :NB_FEATURES]
    T = feats.shape[0] // 4 * 4
    dc = _dred_codec(args)
    zd, sd = dc.encode(feats[None, :T])
    qp = rv.quant_params(dc.params, torch.full((zd.shape[1],), args.quant,
                                               device=dc.device), dc.cfg)
    sym = torch.round(rv.apply_dead_zone(zd[0] * qp["scale"],
                                         qp["dead_zone"]))
    sym = sym.cpu().numpy().astype(np.int16)
    sym.tofile(args.output)
    sd[0].cpu().numpy().astype(np.float32).tofile(args.output + ".state")
    print(f"wrote {sym.shape[0]} latent dframes -> {args.output} "
          f"(on {dc.device})")
    return 0


def cmd_rdovae_decode(args) -> int:
    """Quantized latents -> feature frames (decode_rdovae.py): the whole
    symbol file as one sequence, from the resume state of its first dframe
    (lpcnet_tpu/cli.py:938); features 20-35 are left 0."""
    from .models import rdovae as rv
    dc = _dred_codec(args)
    sym = np.fromfile(args.input, np.int16).reshape(-1, dc.cfg.nb_latents)
    states = np.fromfile(args.input + ".state", np.float32).reshape(
        -1, dc.cfg.state_dim)
    qp = rv.quant_params(dc.params, torch.full(
        (sym.shape[0],), args.quant, device=dc.device), dc.cfg)
    z = torch.as_tensor(sym, dtype=torch.float32,
                        device=dc.device) / qp["scale"]
    feats = rv.decode(dc.params, z[None],
                      torch.as_tensor(states[None, 0], device=dc.device),
                      dc.cfg)[0].cpu().numpy()
    out = np.zeros((feats.shape[0], NB_TOTAL_FEATURES), np.float32)
    out[:, :NB_FEATURES] = feats
    out.tofile(args.output)
    print(f"wrote {out.shape[0]} feature frames -> {args.output} "
          f"(on {dc.device})")
    return 0


def dred_payloads(dc, zd: torch.Tensor, sd: torch.Tensor, step: int = 1):
    """The redundancy payloads of the fec-encode command: for each packet
    position s = n, n+step, ... <= S (n = num_dframes), the symbols of the
    last n dframes quantized with the age ramp, and the features decoded
    from them and the resume state of dframe s-n. Returns a list of
    (s, symbols (B, n, 80) int32 newest first, quant ids (n,),
    features (B, 4n, 20) oldest first)."""
    n = dc.dred.num_dframes
    out = []
    for s in range(n, zd.shape[1] + 1, step):
        sym, qid = dc.quantize_payload(zd[:, :s])
        out.append((s, sym, qid, dc.decode(sym, qid, sd[:, s - n])))
    return out


def cmd_fec_encode(args) -> int:
    """Audio -> superframe features -> latents -> age-ramped redundancy
    payloads, decoded back to features -> a .fec file (fec_encoder.py).
    The rate of a packet is the sum of its |symbols| (a proxy of bits)."""
    from .dred import DREDConfig
    from .utils import fec_packets
    dc = _dred_codec(args, DREDConfig(num_dframes=args.num_redundancy))
    pcm = read_pcm(args.input)
    T = len(pcm) // FRAME_SIZE // 4 * 4
    x = torch.as_tensor(_pad_to_chunks(pcm, T), device=dc.device)
    feats = superframe_features(x[None], T)[..., :NB_FEATURES]
    zd, sd = dc.encode(feats)
    packets, rates = [], []
    for _, sym, _, rec in dred_payloads(dc, zd, sd, args.packets_per_fec):
        fr = np.zeros((rec.shape[1], NB_TOTAL_FEATURES), np.float32)
        fr[:, :NB_FEATURES] = rec[0].cpu().numpy()
        packets.append(fr)
        rates.append(int(min(32767, float(sym.abs().sum()))))
    if not packets:
        raise ValueError(f"{args.input}: {T // 4} dframes, fewer than the "
                         f"{args.num_redundancy} a payload carries")
    fec_packets.write_fec_packets(args.output, packets, rates)
    print(f"wrote {len(packets)} FEC packets ({args.num_redundancy} dframes "
          f"each) -> {args.output} (on {dc.device})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lpcnet_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default: cuda)"
    p = sub.add_parser("features", help="PCM -> feature frames")
    p.add_argument("input", help="s16le PCM (or .wav) input")
    p.add_argument("output", help="float32 feature file (36 per frame)")
    p.add_argument("--quantize-pitch", action="store_true",
                   help="pitch and correlation features as the codec "
                   "quantizes them")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_features)
    p = sub.add_parser("encode", help="PCM -> 1.6 kb/s packets")
    p.add_argument("input", help="s16le PCM (or .wav) input")
    p.add_argument("output", help="packet file, 8 bytes per 40 ms")
    p.add_argument("--codebooks", default=None,
                   help="codebook blob (default: examples/"
                   "codec_codebooks.bin)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_encode)
    p = sub.add_parser("decode", help="1.6 kb/s packets -> PCM")
    p.add_argument("input", help="packet file, 8 bytes per 40 ms")
    p.add_argument("output", help="s16le PCM output")
    p.add_argument("--codebooks", default=None,
                   help="codebook blob (default: examples/"
                   "codec_codebooks.bin)")
    p.add_argument("--weights", default=None,
                   help="vocoder checkpoint, save_params or training "
                   "(default: shipped vocoder)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_decode)
    p = sub.add_parser("synthesis", help="feature frames -> PCM")
    p.add_argument("input", help="float32 feature file (36 per frame)")
    p.add_argument("output", help="s16le PCM output")
    p.add_argument("--weights", default=None,
                   help="vocoder checkpoint, save_params or training "
                   "(default: shipped vocoder)")
    p.add_argument("--streaming", action="store_true",
                   help="reference-exact streaming engine (causal convs, "
                   "FEATURES_DELAY warm-up silence)")
    p.add_argument("--temperature", action="store_true",
                   help="temperature/pdf-floor sampling (plain loop; not "
                   "with --streaming)")
    p.add_argument("--device", default=None, help=device_help)
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
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_plc)
    p = sub.add_parser("plc-test", help="offline PLC network feature test")
    p.add_argument("input", help="float32 frames [burg36|feat20|received], "
                   "last column 1 = frame received")
    p.add_argument("output", help="float32 reconstructed features (20 per "
                   "frame)")
    p.add_argument("--weights", default=None,
                   help="PLC checkpoint (default: shipped PLC network)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_plc_test)
    p = sub.add_parser("addlpc", help="recompute the LPC tail of a feature "
                       "file")
    p.add_argument("input", help="float32 feature file (36 per frame)")
    p.add_argument("output", help="float32 feature file (36 per frame)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_addlpc)
    p = sub.add_parser("dump-weights-blob",
                       help="bundle checkpoints into one DNNw blob")
    p.add_argument("output", help="DNNw blob")
    p.add_argument("models", nargs="+",
                   help="prefix=checkpoint.bin (e.g. lpcnet=ck.bin)")
    p.set_defaults(fn=cmd_dump_weights_blob)
    dred_help = ("RDO-VAE checkpoint: save_params or training blob, "
                 "reference .pth/.pt, or wexchange directory (default: "
                 "examples/speech_dred_params.bin)")
    for name, helptext, fn in (
            ("rdovae-encode", "features -> quantized latents",
             cmd_rdovae_encode),
            ("rdovae-decode", "quantized latents -> features",
             cmd_rdovae_decode)):
        p = sub.add_parser(name, help=helptext)
        p.add_argument("input")
        p.add_argument("output")
        p.add_argument("--weights", default=None, help=dred_help)
        p.add_argument("--quant", type=int, default=15,
                       help="quant level of every dframe (0-15)")
        p.add_argument("--device", default=None, help=device_help)
        p.set_defaults(fn=fn)
    p = sub.add_parser("fec-encode", help="audio -> DRED .fec redundancy")
    p.add_argument("input", help="s16le PCM (or .wav) input")
    p.add_argument("output", help=".fec file")
    p.add_argument("--weights", default=None, help=dred_help)
    p.add_argument("--num-redundancy", type=int, default=16,
                   help="dframes per payload")
    p.add_argument("--packets-per-fec", type=int, default=1,
                   help="dframes between payloads")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_fec_encode)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
