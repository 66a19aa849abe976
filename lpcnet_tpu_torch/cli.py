"""Command line of the PyTorch/CUDA port: the subcommands of
lpcnet_tpu/cli.py (reference lpcnet_demo -features, -synthesis, -encode,
-decode, -plc_file and -addlpc, dump_data, ceps_vq_train,
dump_weights_blob, and the training and DRED scripts of training_tf2/).

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
    python -m lpcnet_tpu_torch dump-data train|test|btrain|btest|qtrain|qtest
        in.pcm feats.f32 [data.s16] [--passes N --batch-passes M]
    python -m lpcnet_tpu_torch vq-train feats.f32 codebooks.bin
    python -m lpcnet_tpu_torch train-lpcnet feats.f32 data.s16 outdir
    python -m lpcnet_tpu_torch train-plc feats.f32 outdir
    python -m lpcnet_tpu_torch train-rdovae feats.f32 outdir

The training commands (dump-data, vq-train, train-*) take the JAX
package's arguments and defaults and write its files: the same feature
and data layouts, codebook blobs, ckpt_{epoch:03d}.bin training
checkpoints (loadable and resumable by either package) and metrics.jsonl.
Every command but dump-weights-blob (numpy only) takes --device (default:
the card; --device cpu runs the plain PyTorch paths). Feature files are
float32 frames of 36; audio is 16-bit little-endian PCM at 16 kHz
(headerless, or .wav on input); a packet is 8 bytes per 40 ms (1.6 kb/s).
--weights and --plc-weights of synthesis, decode and plc, and
train-lpcnet's --retrain, also take a reference Keras .h5 checkpoint
(convert.load_lpcnet_model / load_plc_model; reading one needs h5py).
Omitted --weights, --plc-weights and --codebooks load
examples/speech_lpcnet_params.bin, examples/speech_plc_params.bin (the PLC
network, also plc-test's --weights), examples/speech_dred_params.bin (the
DRED commands) and examples/codec_codebooks.bin.
`synthesis` and `decode` read LPCNET_KERNEL_TABLES (f32, the default, or
bf16: the frame kernel's embedding tables in bfloat16), as the JAX
package's Synthesizer does.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from .constants import (DRED_COND_SIZE, FRAME_SIZE, LPCNET_COMPRESSED_SIZE,
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
    params, cfg = convert.load_lpcnet_model(args.weights,
                                            device=args.device)
    voc = Synthesizer(cfg, params=params, device=args.device,
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
    params, cfg = convert.load_lpcnet_model(args.weights,
                                            device=args.device)
    voc = Synthesizer(cfg, params=params, device=args.device,
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
    params, cfg = convert.load_lpcnet_model(
        args.weights, cls._default_cfg(), device=args.device)
    plc_params, plc_cfg = convert.load_plc_model(args.plc_weights,
                                                 device=args.device)
    engine = cls(params, plc_params, cfg, plc_cfg,
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


# ---------------------------------------------------------------- dump-data

def _hp_biquad(x: np.ndarray) -> np.ndarray:
    """The DC-blocking high-pass of all dump_data input (dump_data.c:
    114-115, 258: b = {-2, 1}, a = {-1.99599, .996}): native where the
    library is available, else a per-sample loop (short files only)."""
    from .data import _ptr
    from .utils import native
    lib = native.get_lib()
    x = np.ascontiguousarray(x, np.float32)
    if lib is not None:
        y = np.empty_like(x)
        lib.dp_hp_biquad(_ptr(y), _ptr(x), len(x))
        return y
    b = (-2.0, 1.0)
    a = (-1.99599, 0.99600)
    y = np.empty_like(x, np.float32)
    m0 = m1 = 0.0
    for i in range(len(x)):
        xi = float(x[i])
        yi = np.float32(xi + m0)
        m0 = m1 + np.float32(b[0] * xi - a[0] * yi)
        m1 = np.float32(b[1] * xi - a[1] * yi)
        y[i] = yi
    return y


def _dump_test(args, pcm: np.ndarray, cbs, dev) -> int:
    """The test, btest and qtest modes: features of the high-passed input,
    no augmentation, CHUNK_FRAMES frames per call. test and btest run the
    per-frame pitch path (process_single_frame, dump_data.c:283), qtest
    the superframe path quantized through the codec (:288); btest puts
    each frame's Burg cepstra first, [burg36 | feat36]."""
    from . import features as F
    from .codec import codec
    from .ops import burg
    pcm = _hp_biquad(pcm)
    T = len(pcm) // FRAME_SIZE // 4 * 4
    pcm = torch.as_tensor(_pad_to_chunks(pcm, T), device=dev)
    state = F.init_state(1, dev)
    vq_mem = torch.zeros((1, NB_BANDS), device=dev)
    mode = "single" if cbs is None else "superframe"
    outs = []
    for t0 in range(0, pcm.shape[0] // FRAME_SIZE, CHUNK_FRAMES):
        x = pcm[None, t0 * FRAME_SIZE:(t0 + CHUNK_FRAMES) * FRAME_SIZE]
        state, f, sps = F.compute_features(state, x,
                                           quantize_pitch=cbs is not None,
                                           mode=mode)
        if cbs is not None:
            n = min(CHUNK_FRAMES, T - t0) // 4
            if n:
                _, fq, vq_mem = codec.encode_superframes(
                    cbs, f[:, :4 * n], vq_mem, sps[:n])
                f = torch.cat([fq, f[:, 4 * n:]], dim=1)
        if args.mode == "btest":
            b36 = burg.burg_cepstral_analysis(x[0].reshape(-1, FRAME_SIZE))
            f = torch.cat([b36[None], f], dim=-1)
        outs.append(f[0].cpu().numpy())
    allf = np.concatenate(outs)[:T].astype(np.float32)
    allf.tofile(args.features)
    print(f"wrote {T} x {allf.shape[1]} feature frames -> {args.features}")
    return 0


def cmd_dump_data(args) -> int:
    """Training and test data (src/dump_data.c:110-306):
    train  = augmentation + features + (sig_in, sig_out) pairs
    test   = clean features only
    btrain = train with per-frame Burg cepstra first, [burg36 | feat36]
             (the PLC training format, dump_data.c:145-150, 266-270)
    btest  = clean [burg36 | feat36] frames, no augmentation
    qtrain/qtest = train/test with the features quantized through the
             codec (dump_data.c:154-161); --codebooks for trained ones.
    The input may be a directory of voices: train and btrain then run
    --passes passes over every training voice of its manifest.json (else
    every *.s16 in it)."""
    import glob
    import json
    from . import data as D
    from .device import resolve_device
    dev = resolve_device(args.device)
    sources = None
    if os.path.isdir(args.input):
        if args.mode not in ("train", "btrain"):
            raise ValueError("directory input is for the train and btrain "
                             "corpus modes")
        man_path = os.path.join(args.input, "manifest.json")
        if os.path.exists(man_path):
            with open(man_path) as f:
                names = json.load(f)["train"]
        else:
            names = sorted(os.path.basename(p) for p in
                           glob.glob(os.path.join(args.input, "*.s16")))
        sources = [(n, read_pcm(os.path.join(args.input, n)))
                   for n in names]
        print(f"corpus input: {len(sources)} training voices "
              f"x {args.passes} passes", flush=True)
        pcm = sources[0][1]
    else:
        pcm = read_pcm(args.input)
    cbs = load_codebooks(args.codebooks, dev) \
        if args.mode in ("qtrain", "qtest") else None
    if args.mode in ("test", "btest", "qtest"):
        return _dump_test(args, pcm, cbs, dev)
    if not args.data:
        raise ValueError("the train modes need an output data.s16 path")
    srcs = sources or [(os.path.basename(args.input), pcm)]
    batched = args.mode == "train" and args.batch_passes > 1
    total, width = 0, NB_TOTAL_FEATURES
    with open(args.features, "wb") as ff, open(args.data, "wb") as fd:
        for vi, (vname, vpcm) in enumerate(srcs):
            # a per-voice seed offset: no two (voice, pass) pairs share
            # augmentation filters
            vseed = args.seed + 100003 * vi
            for p0 in range(0, args.passes,
                            args.batch_passes if batched else 1):
                if batched:
                    # passes as parallel batched feature streams
                    seeds = range(vseed + p0, vseed + min(
                        args.passes, p0 + args.batch_passes))
                    feats, data = D.prepare_training_data_batch(
                        vpcm, seeds, speed_aug=args.speed_aug, device=dev)
                elif args.mode == "btrain":
                    feats, data, burg36 = D.prepare_training_data(
                        vpcm, seed=vseed + p0, include_burg=True,
                        device=dev)
                    feats = np.concatenate([burg36, feats], axis=-1)
                else:
                    feats, data = D.prepare_training_data(
                        vpcm, seed=vseed + p0, quantize_codebooks=cbs,
                        device=dev)
                feats.astype(np.float32).tofile(ff)
                data.astype(np.int16).tofile(fd)
                total += feats.shape[0]
                width = feats.shape[1]
                if batched:
                    print(f"  {vname} pass {p0 + len(seeds)}/{args.passes}"
                          f": {total} frames", flush=True)
    print(f"wrote {total} x {width} frames "
          f"({args.passes} passes x {len(srcs)} sources) -> "
          f"{args.features}, {args.data}")
    return 0


# ---------------------------------------------------------------- vq-train

def cmd_vq_train(args) -> int:
    """Codec codebooks from a feature file (src/ceps_vq_train.c:433-619)."""
    from .codec import vq_train
    from .device import resolve_device
    from .utils import weights_io
    dev = resolve_device(args.device)
    feats = read_features(args.input)
    cbs = vq_train.train_codec_codebooks(
        torch.Generator(device=dev).manual_seed(args.seed),
        torch.as_tensor(feats, device=dev), iters=args.iters,
        final_iters=args.final_iters)
    weights_io.save_params(args.output, {k: v.cpu().numpy()
                                         for k, v in cbs.items()})
    print(f"trained codebooks on {feats.shape[0]} frames -> {args.output}")
    return 0


# ---------------------------------------------------------------- training

def _ckpt_path(outdir: str, epoch: int) -> str:
    os.makedirs(outdir, exist_ok=True)
    return os.path.join(outdir, f"ckpt_{epoch:03d}.bin")


def _log_metrics(outdir: str, record: dict) -> None:
    """One JSON line per epoch in <outdir>/metrics.jsonl (the keys of the
    JAX package's trainers)."""
    import json
    os.makedirs(outdir, exist_ok=True)
    record = dict(record, time=round(time.time(), 3))
    with open(os.path.join(outdir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def _start(args, opt, init, dev):
    """(params on dev, optimizer state, step, first epoch): from --resume's
    checkpoint (its step, Adam moments and schedule count), or init() of a
    CPU generator seeded by --seed."""
    from . import convert
    from .training import optim
    from .utils import checkpoint
    if args.resume:
        tree, leaves, step, meta = checkpoint.load_training(args.resume)
        params = convert.params_from_numpy(tree, dev)
        return (params, optim.state_from_leaves(leaves, params), step,
                int(meta.get("epoch", -1)) + 1)
    params = convert.to_device(init(torch.Generator().manual_seed(args.seed)),
                               dev)
    return params, opt.init(params), 0, 0


def _end_epoch(args, params, opt_state, step, meta, record, n, tot) -> str:
    """Write the epoch's checkpoint and metrics line; returns the
    checkpoint's path."""
    from . import convert
    from .training import optim
    from .utils import checkpoint
    ck = _ckpt_path(args.outdir, meta["epoch"])
    checkpoint.save_training(ck, convert.params_to_numpy(params),
                             optim.state_leaves(opt_state), step, meta)
    _log_metrics(args.outdir, dict(
        {"task": meta["cfg"], "epoch": meta["epoch"], "step": step,
         "steps": n, "loss": round(tot / max(1, n), 6)}, **record))
    return ck


def cmd_train_lpcnet(args) -> int:
    """LPCNet trainer (training_tf2/train_lpcnet.py): teacher-forced CE,
    sparsify/quantize schedules, per-epoch checkpoints, resume."""
    from . import convert
    from . import data as D
    from .device import resolve_device
    from .models import lpcnet
    from .training import lpcnet_task, sparsify
    dev = resolve_device(args.device)
    feats = read_features(args.features)
    data = np.fromfile(args.data, np.int16).reshape(-1, 2)
    cfg = lpcnet.LPCNetConfig(e2e=args.e2e, lpc_gamma=args.gamma)
    opt = lpcnet_task.make_optimizer(lr=args.lr, decay=args.decay,
                                     b1=args.beta1, b2=args.beta2)
    params, opt_state, step, epoch0 = _start(
        args, opt, lambda g: lpcnet.init_params(g, cfg), dev)
    if args.retrain and not args.resume:
        params, rcfg = convert.load_lpcnet_model(args.retrain, cfg,
                                                 device=dev)
        # a .h5 brings its own widths; --e2e and --gamma stay the recipe's
        cfg = dataclasses.replace(rcfg, e2e=args.e2e, lpc_gamma=args.gamma)
        opt_state = opt.init(params)
    # schedules: from scratch or quantize-finetune (train_lpcnet.py:303-317)
    t0, t1, iv = (10000, 30000, 100) if args.quantize else (2000, 40000, 400)
    if args.sparsify_start is not None:
        t0 = args.sparsify_start
    if args.sparsify_end is not None:
        t1 = args.sparsify_end
    scfg = sparsify.SparsifyConfig(t_start=t0, t_end=t1, interval=iv,
                                   quantize=args.quantize,
                                   density=tuple(args.density),
                                   grub_density=tuple(args.grub_density))
    noise = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for ep in range(args.epochs):
        epoch = epoch0 + ep
        tw = time.perf_counter()
        n, tot = 0, 0.0
        for batch in D.window_batches(
                feats, data, batch_size=args.batch_size,
                rng=np.random.RandomState(args.seed + epoch)):
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            params, opt_state, metrics = lpcnet_task.train_step(
                params, opt_state, tb, cfg, opt, noise)
            params = sparsify.apply(params, step, scfg, cfg.gru_a_units)
            step += 1
            n += 1
            tot += float(metrics["loss"])
            if args.steps_per_epoch and n >= args.steps_per_epoch:
                break
        wall = time.perf_counter() - tw
        ck = _end_epoch(args, params, opt_state, step,
                        {"epoch": epoch, "cfg": "lpcnet"},
                        {"wall_s": round(wall, 2)}, n, tot)
        print(f"epoch {epoch}: {n} steps, loss {tot / max(1, n):.4f}, "
              f"{wall:.1f}s -> {ck}")
    return 0


def cmd_train_plc(args) -> int:
    """PLC trainer (training_tf2/train_plc.py): masked L1 losses over
    simulated loss traces."""
    from .device import resolve_device
    from .models import plc as plc_model
    from .training import plc_task
    dev = resolve_device(args.device)
    width = 2 * NB_BANDS + NB_FEATURES           # 56
    btrain_w = 2 * NB_BANDS + NB_TOTAL_FEATURES  # 72
    raw = np.fromfile(args.features, np.float32)
    div72, div56 = raw.size % btrain_w == 0, raw.size % width == 0
    fmt = args.feature_width
    if fmt == "auto":
        if div72 and div56:
            print(f"error: {args.features}: size {raw.size} is divisible "
                  f"by both 72 (btrain) and 56 — pass --feature-width",
                  file=sys.stderr)
            return 1
        fmt = "72" if div72 else "56"
    # the btrain layout [burg36 | feat36] keeps burg36 + feat20
    # (train_plc.py:246-260)
    feats = raw.reshape(-1, btrain_w)[:, :width] if fmt == "72" \
        else raw.reshape(-1, width)
    if args.loss_traces:
        traces = np.loadtxt(args.loss_traces, dtype=np.int64).reshape(-1)
    else:
        traces = (np.random.RandomState(args.seed)
                  .uniform(size=200000) > 0.2).astype(np.int64)
    cfg = plc_model.PLCConfig()
    opt = plc_task.make_optimizer(lr=args.lr)
    params, opt_state, step, epoch0 = _start(
        args, opt, lambda g: plc_model.init_params(g, cfg), dev)
    T = args.seq_len
    nseq = feats.shape[0] // T
    feats = feats[:nseq * T].reshape(nseq, T, width)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for ep in range(args.epochs):
        epoch = epoch0 + ep
        order = np.random.RandomState(args.seed + epoch).permutation(nseq)
        n, tot = 0, 0.0
        for b0 in range(0, nseq - args.batch_size + 1, args.batch_size):
            sel = order[b0:b0 + args.batch_size]
            # loss simulation from the traces at random offsets
            # (plc_loader.py:56-75)
            off = np.random.RandomState(step).randint(
                0, max(1, len(traces) - T), size=len(sel))
            lost = np.stack([traces[o:o + T] for o in off])
            batch = plc_task.make_batch(
                gen, torch.as_tensor(feats[sel], device=dev),
                torch.as_tensor(lost, device=dev))
            params, opt_state, metrics = plc_task.train_step(
                params, opt_state, batch, cfg, opt)
            step += 1
            n += 1
            tot += float(metrics["loss"])
            if args.steps_per_epoch and n >= args.steps_per_epoch:
                break
        ck = _end_epoch(args, params, opt_state, step,
                        {"epoch": epoch, "cfg": "plc"}, {}, n, tot)
        print(f"epoch {epoch}: {n} steps, loss {tot / max(1, n):.4f} "
              f"-> {ck}")
    return 0


def cmd_train_rdovae(args) -> int:
    """RDO-VAE trainer (training_tf2/train_rdovae.py): lambda-conditioned
    rate-distortion training."""
    from .device import resolve_device
    from .models import rdovae as rv
    from .training import rdovae_task
    dev = resolve_device(args.device)
    feats = read_features(args.features)[:, :NB_FEATURES]
    cfg = rv.RDOVAEConfig(cond_size=args.cond_size,
                          cond_size2=args.cond_size2)
    opt = rdovae_task.make_optimizer(lr=args.lr)

    def init(g):
        params = rv.init_params(g, cfg)
        # the RD-ordered per-level scales (rv.rate_aware_quant_init)
        return rv.rate_aware_quant_init(params, cfg) if args.rate_init \
            else params

    params, opt_state, step, epoch0 = _start(args, opt, init, dev)
    T = args.seq_len
    nseq = feats.shape[0] // T
    feats = feats[:nseq * T].reshape(nseq, T, NB_FEATURES)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for ep in range(args.epochs):
        epoch = epoch0 + ep
        order = np.random.RandomState(args.seed + epoch).permutation(nseq)
        n, tot = 0, 0.0
        for b0 in range(0, nseq - args.batch_size + 1, args.batch_size):
            sel = order[b0:b0 + args.batch_size]
            qid, lam = rdovae_task.sample_lambda(gen, len(sel), T // 2,
                                                 device=dev)
            params, opt_state, metrics = rdovae_task.train_step(
                params, opt_state, torch.as_tensor(feats[sel], device=dev),
                qid, lam, gen, cfg, opt)
            step += 1
            n += 1
            tot += float(metrics["loss"])
            if args.steps_per_epoch and n >= args.steps_per_epoch:
                break
        ck = _end_epoch(args, params, opt_state, step,
                        {"epoch": epoch, "cfg": "rdovae",
                         "cond_size": cfg.cond_size,
                         "cond_size2": cfg.cond_size2}, {}, n, tot)
        print(f"epoch {epoch}: {n} steps, loss {tot / max(1, n):.4f} "
              f"-> {ck}")
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
                   help="vocoder checkpoint, save_params, training or "
                   "Keras .h5 (default: shipped vocoder)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_decode)
    p = sub.add_parser("synthesis", help="feature frames -> PCM")
    p.add_argument("input", help="float32 feature file (36 per frame)")
    p.add_argument("output", help="s16le PCM output")
    p.add_argument("--weights", default=None,
                   help="vocoder checkpoint, save_params, training or "
                   "Keras .h5 (default: shipped vocoder)")
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
                   help="vocoder checkpoint or Keras .h5 (default: "
                   "shipped vocoder)")
    p.add_argument("--plc-weights", default=None,
                   help="PLC checkpoint or Keras .h5 (default: shipped PLC "
                   "network)")
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
    _training_parsers(sub, device_help)
    return ap


def _train_common(p, device_help) -> None:
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from (params+opt+step)")
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="cap steps per epoch (0 = all data)")
    p.add_argument("--device", default=None, help=device_help)


def _training_parsers(sub, device_help) -> None:
    """The training commands, with the JAX package's arguments and
    defaults (lpcnet_tpu/cli.py) and --device."""
    p = sub.add_parser("dump-data", help="training/test data prep")
    p.add_argument("mode", choices=["train", "test", "btrain", "btest",
                                    "qtrain", "qtest"])
    p.add_argument("input")
    p.add_argument("features")
    p.add_argument("data", nargs="?", default=None)
    p.add_argument("--passes", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--codebooks", default=None,
                   help="trained codec codebooks for qtrain/qtest")
    p.add_argument("--batch-passes", type=int, default=1,
                   help="train mode: run this many augmentation passes as "
                   "parallel batched feature streams (corpus building)")
    p.add_argument("--speed-aug", action="store_true",
                   help="train mode with --batch-passes: per-pass random "
                   "resampling in [0.7, 1.4] for pitch diversity")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_dump_data)

    p = sub.add_parser("vq-train", help="train codec VQ codebooks")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--iters", type=int, default=4,
                   help="Lloyd passes per codebook split (the C recipe's "
                   "4, ceps_vq_train.c:361)")
    p.add_argument("--final-iters", type=int, default=20,
                   help="polish passes at full size (the C's 20)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_vq_train)

    p = sub.add_parser("train-lpcnet", help="train the vocoder")
    p.add_argument("features")
    p.add_argument("data")
    p.add_argument("outdir")
    _train_common(p, device_help)
    p.add_argument("--decay", type=float, default=5e-5)
    p.add_argument("--beta1", type=float, default=0.5,
                   help="Adam beta_1 (reference train_lpcnet.py:229)")
    p.add_argument("--beta2", type=float, default=0.8)
    p.add_argument("--e2e", action="store_true")
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--quantize", action="store_true",
                   help="int8 quantize-finetune schedule")
    p.add_argument("--retrain", default=None,
                   help="params checkpoint, or reference Keras .h5, to "
                   "warm-start from")
    p.add_argument("--density", type=float, nargs=3,
                   default=[0.05, 0.05, 0.2])
    p.add_argument("--grub-density", type=float, nargs=3,
                   default=[1.0, 1.0, 1.0])
    p.add_argument("--sparsify-start", type=int, default=None,
                   help="override the sparsify schedule's start batch "
                   "(defaults: 2000 from-scratch / 10000 quantize)")
    p.add_argument("--sparsify-end", type=int, default=None,
                   help="override the sparsify schedule's end batch "
                   "(defaults: 40000 / 30000)")
    p.set_defaults(fn=cmd_train_lpcnet)

    p = sub.add_parser("train-plc", help="train the PLC predictor")
    p.add_argument("features", help="f32 frames [burg36|feat20]")
    p.add_argument("outdir")
    _train_common(p, device_help)
    p.add_argument("--loss-traces", default=None,
                   help="text file of 0/1 flags (1 = received)")
    p.add_argument("--seq-len", type=int, default=1000)
    p.add_argument("--feature-width", default="auto",
                   choices=["auto", "56", "72"],
                   help="56 = [burg36|feat20], 72 = dump-data btrain "
                   "[burg36|feat36]; auto errors when ambiguous")
    p.set_defaults(fn=cmd_train_plc)

    p = sub.add_parser("train-rdovae", help="train the DRED RDO-VAE")
    p.add_argument("features")
    p.add_argument("outdir")
    _train_common(p, device_help)
    p.add_argument("--seq-len", type=int, default=400)
    p.add_argument("--cond-size", type=int, default=DRED_COND_SIZE,
                   help="GRU width (1024 = TF trainer default; 256 = the "
                   "torch trainer's deployable geometry)")
    p.add_argument("--cond-size2", type=int, default=256)
    p.add_argument("--rate-init", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="start the 16 quantizer levels on the RD-optimal "
                   "scale(q) ~ sqrt(lambda(q)) instead of the reference's "
                   "all-equal zero init (models/rdovae.py::"
                   "rate_aware_quant_init)")
    p.set_defaults(fn=cmd_train_rdovae)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
