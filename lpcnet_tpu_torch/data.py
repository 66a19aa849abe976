"""Training data: the dump_data(-train) pipeline and the batch loader (the
port of lpcnet_tpu/data.py; reference src/dump_data.c:110-306).

Per utterance stream:
  1. augmentation (native C++: random biquads, gain ramps, pre-emphasis,
     dither) and per-sample mu-law noise draws            [host]
  2. feature extraction, features.compute_features      [device]
  3. (sig_in, sig_out) pairs with noised-excitation feedback through the
     LPC predictor (native C++, or a numpy loop)         [host]
  4. training windows: 15 frames of PCM (2400 samples) with 19 feature
     frames of conv context (dataloader.py:17-70)
Without the native library, augment raises and build_pairs runs its numpy
loop (slow; for tests).

The device steps that the commands, the bench and the tools call once per
chunk are jit entry points (utils/graphs.py) kept here, as the JAX
package keeps its jitted feature step (lpcnet_tpu/data.py:96-106):
feature_step(quantize, mode) per key and codec_step(kind, codebooks) per
codec call and codebooks dict, one slot per kind (new codebooks evict the
old ones' graphs, as lpcnet_tpu/data.py:148-156 does). On the card the
first call of a shape runs eagerly, the second captures it, and later
ones replay it; whole-chunk callers pad to one shape. Burg needs no graph:
on the card ops/burg.burg_cepstral_analysis is one kernel launch.
"""
import ctypes
import functools
import sys
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from . import features as F
from .constants import FRAME_SIZE, LPC_ORDER, TRAINING_OFFSET
from .device import resolve_device
from .ops import burg, dsp
from .utils import graphs, native

CHUNK = 256            # frames per compute_features call
_LPC = slice(18 + 2, 18 + 2 + LPC_ORDER)   # the LPC columns of a frame


_FEATURE_STEPS: Dict[Tuple[bool, str], graphs.jit] = {}
_CODEC_STEPS: Dict[str, Tuple[int, graphs.jit]] = {}
CODEC_KINDS = ("encode_superframe", "encode_superframes", "decode_packet",
               "decode_packets")


def feature_step(quantize: bool, mode: str = "superframe") -> graphs.jit:
    """features.compute_features(state, pcm, quantize_pitch=quantize,
    mode=mode) as a jit entry point, one per (quantize, mode), made on its
    first request and kept for the process (JAX's _feature_step_fn)."""
    key = (bool(quantize), mode)
    if key not in _FEATURE_STEPS:
        _FEATURE_STEPS[key] = graphs.jit(
            functools.partial(F.compute_features, quantize_pitch=key[0],
                              mode=mode),
            f"data.feature_step(quantize={key[0]}, mode={mode})")
    return _FEATURE_STEPS[key]


def codec_step(kind: str, codebooks) -> graphs.jit:
    """codec.<kind>(codebooks, ...) as a jit entry point ("data.<kind>")
    over the codebooks dict `codebooks`, whose tensors the graphs read
    where they lie. One slot per kind, keyed by the dict's identity: a new
    dict replaces the kind's jit and its graphs (the JAX package's
    single-slot cache of its encode step)."""
    if kind not in CODEC_KINDS:
        raise ValueError(f"kind must be one of {CODEC_KINDS}, not {kind!r}")
    slot = _CODEC_STEPS.get(kind)
    if slot is None or slot[0] != id(codebooks):
        from .codec import codec
        slot = _CODEC_STEPS[kind] = (id(codebooks), graphs.jit(
            functools.partial(getattr(codec, kind), codebooks),
            f"data.{kind}"))
    return slot[1]



def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def augment(pcm: np.ndarray, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Augment one stream of samples (cut to whole frames). Returns
    (augmented float32 samples, per-sample mu-law noise int32)."""
    n = len(pcm) // FRAME_SIZE * FRAME_SIZE
    x = np.array(pcm[:n], dtype=np.float32, copy=True)  # augmented in place
    noise = np.zeros(n, dtype=np.int32)
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(f"native library {native.NATIVE.how}")
    st = lib.dp_augment_create(ctypes.c_uint64(seed))
    try:
        lib.dp_augment_frames(st, _ptr(x), _ptr(noise), n // FRAME_SIZE)
    finally:
        lib.dp_augment_destroy(st)
    return x, noise


def build_pairs(pcm: np.ndarray, lpc: np.ndarray, noise: np.ndarray
                ) -> np.ndarray:
    """(sig_in, sig_out) pairs (write_audio, dump_data.c:84-108). pcm: (S,)
    int16; lpc: (T, 16) float32; noise: (S,) int32. Returns (S, 2) int16.
    The numpy loop runs where the native library is unavailable."""
    S = len(pcm)
    T = S // FRAME_SIZE
    lib = native.get_lib()
    if lib is not None:
        out = np.zeros(2 * S, dtype=np.int16)
        pcm = np.ascontiguousarray(pcm, np.int16)
        lpc = np.ascontiguousarray(lpc, np.float32)
        noise = np.ascontiguousarray(noise, np.int32)
        sig_mem = np.zeros(LPC_ORDER, dtype=np.float32)
        exc_mem = np.zeros(1, dtype=np.int32)
        lib.dp_build_pairs(_ptr(pcm), _ptr(lpc), _ptr(noise), T,
                           _ptr(sig_mem), _ptr(exc_mem), _ptr(out))
        return out.reshape(S, 2)
    from .ops.mulaw import ULAW2LIN_TABLE, lin2ulaw
    sig_mem = np.zeros(LPC_ORDER, np.float32)
    res = np.zeros((S, 2), np.int16)
    for k in range(T):
        A = lpc[k]
        for i in range(FRAME_SIZE):
            s = k * FRAME_SIZE + i
            p = -float(A @ sig_mem)
            e = int(lin2ulaw(torch.tensor(np.float32(pcm[s] - p))))
            res[s, 0] = np.int16(np.clip(np.floor(0.5 + sig_mem[0]),
                                         -32767, 32767))
            res[s, 1] = pcm[s]
            e = int(np.clip(e + noise[s], 0, 255))
            sig_mem[1:] = sig_mem[:-1]
            sig_mem[0] = p + ULAW2LIN_TABLE[e]
    return res


def _features(z: torch.Tensor, T: int, codebooks=None) -> np.ndarray:
    """Superframe features of the de-emphasized streams z (N, >= T*160),
    CHUNK frames per call; with codebooks, quantized through the codec
    (the -qtrain mode). Returns (N, T, 36) float32."""
    N = z.shape[0]
    state = F.init_state(N, z.device)
    quant = codebooks is not None
    step = feature_step(quant)
    if quant:
        encode = codec_step("encode_superframes", codebooks)
        vq_mem = torch.zeros((N, 18), device=z.device)
    parts = []
    for t0 in range(0, T, CHUNK):
        t1 = min(T, t0 + CHUNK)
        state, f, sps = step(state, z[:, t0 * FRAME_SIZE:t1 * FRAME_SIZE])
        if quant:
            _, f, vq_mem = encode(f, vq_mem, sps)
        parts.append(f.cpu().numpy())
    return np.concatenate(parts, axis=1)


def _delayed_pcm16(x: np.ndarray) -> np.ndarray:
    """The samples delayed by TRAINING_OFFSET (dump_data.c:273-274), as
    int16."""
    S = len(x)
    pcm_del = np.zeros(S, np.float32)
    pcm_del[TRAINING_OFFSET:] = x[:S - TRAINING_OFFSET]
    return np.clip(np.floor(0.5 + pcm_del), -32767, 32767).astype(np.int16)


def prepare_training_data(pcm: np.ndarray, seed: int = 0,
                          include_burg: bool = False,
                          quantize_codebooks=None, device=None):
    """Raw int16 speech -> (features (T, 36), data (S, 2)): augmentation,
    features on `device` (None means the card) of the de-emphasized
    signal, the PCM delayed by TRAINING_OFFSET, pairs.

    include_burg: also return per-frame Burg cepstra (T, 36) of the
    de-emphasized signal (the -btrain mode, dump_data.c:266-270).
    quantize_codebooks: codec codebooks on `device`; the features are
    quantized through the codec before the pairs are built (-qtrain,
    dump_data.c:154-157)."""
    dev = resolve_device(device)
    x, noise = augment(pcm, seed)
    T = len(x) // FRAME_SIZE // 4 * 4
    S = T * FRAME_SIZE
    x, noise = x[:S], noise[:S]
    # the augmenter pre-emphasized (dump_data.c:271); compute_features
    # applies its own pre-emphasis
    z, _ = dsp.deemphasis_scan(torch.as_tensor(x[None], device=dev),
                               torch.zeros(1, device=dev))
    feats = _features(z, T, quantize_codebooks)[0]
    data = build_pairs(_delayed_pcm16(x), feats[:, _LPC], noise)
    if include_burg:
        # one call over the whole corpus: eager, as a jit's first call is
        burg36 = burg.burg_cepstral_analysis(
            z[0, :S].reshape(T, FRAME_SIZE)).cpu().numpy()
        return feats, data, burg36
    return feats, data


def _resample_linear(x: np.ndarray, speed: float) -> np.ndarray:
    """Linear-interpolation resampling (speed > 1: faster, higher pitch),
    the speaker/pitch diversity the reference's augmentation lacks."""
    n = int(len(x) / speed)
    idx = np.arange(n, dtype=np.float64) * speed
    i0 = idx.astype(np.int64)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    frac = (idx - i0).astype(np.float32)
    return ((1.0 - frac) * x[i0] + frac * x[i1]).astype(np.float32)


def prepare_training_data_batch(pcm: np.ndarray, seeds,
                                speed_aug: bool = False, device=None):
    """N augmentation passes of one source as N parallel feature streams
    (one batched compute_features call per chunk). speed_aug draws a
    per-pass resampling factor in [0.7, 1.4]. Returns (features (N*T, 36),
    data (N*T*160, 2)), the passes in seed order."""
    dev = resolve_device(device)
    seeds = list(seeds)
    N = len(seeds)
    xs, noises = [], []
    for seed in seeds:
        base = pcm
        if speed_aug:
            speed = np.random.RandomState(seed ^ 0x5EED).uniform(0.7, 1.4)
            base = _resample_linear(np.asarray(pcm, np.float32), speed)
        x, noise = augment(base, seed)
        xs.append(x)
        noises.append(noise)
    # one length for the batch: whole superframes of the shortest pass
    # (with speed_aug, of the slowest possible pass, so the shapes do not
    # change from batch to batch); longer passes give a seeded window
    if speed_aug:
        T = int(len(pcm) / 1.4) // FRAME_SIZE // 4 * 4
    else:
        T = min(len(x) for x in xs) // FRAME_SIZE // 4 * 4
    S = T * FRAME_SIZE
    offs = [np.random.RandomState(seed ^ 0x0FF5E7)
            .randint(0, (len(x) - S) // FRAME_SIZE + 1) * FRAME_SIZE
            for seed, x in zip(seeds, xs)]
    X = np.stack([x[o:o + S] for o, x in zip(offs, xs)])  # (N, S)
    noises = [n[o:o + S] for o, n in zip(offs, noises)]
    gen = sum(len(x) for x in xs)
    if N > 1 and S * N < 0.95 * gen:
        print("  [batch] keeping %.0f%% of generated samples "
              "(shortest pass sets the batch length; longer passes "
              "contribute random windows)" % (100.0 * S * N / gen),
              file=sys.stderr)
    z, _ = dsp.deemphasis_scan(torch.as_tensor(X, device=dev),
                               torch.zeros(N, device=dev))
    feats = _features(z, T)                             # (N, T, 36)
    data = [build_pairs(_delayed_pcm16(X[i]), feats[i, :, _LPC], noises[i])
            for i in range(N)]
    return (np.concatenate(list(feats)).astype(np.float32),
            np.concatenate(data))


def window_batches(features: np.ndarray, data: np.ndarray,
                   batch_size: int = 128, frames_per_chunk: int = 15,
                   lookahead: int = 2,
                   rng: Optional[np.random.RandomState] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Training windows (train_lpcnet.py:262-292, dataloader.py:17-70): 15
    output frames / 2400 samples per chunk with 4 more feature frames of
    conv context, LPC targets shifted by lookahead; chunks in rng's
    permutation, whole batches only. Yields dicts of numpy arrays for
    training.lpcnet_task.forward."""
    T = features.shape[0]
    S = data.shape[0]
    ctx = frames_per_chunk + 4
    nch = min((T - 4) // frames_per_chunk,
              S // (frames_per_chunk * FRAME_SIZE))
    rng = rng or np.random.RandomState(0)
    chunks = []
    for c in range(nch):
        f0 = c * frames_per_chunk
        if f0 + ctx > T:
            break
        s0 = c * frames_per_chunk * FRAME_SIZE
        s1 = s0 + frames_per_chunk * FRAME_SIZE
        feats = features[f0:f0 + ctx]
        lpc0 = 4 - lookahead + f0
        chunks.append({
            "sig_in": data[s0:s1, 0].astype(np.float32),
            "sig_out": data[s0:s1, 1].astype(np.float32),
            "features": feats[:, :20].astype(np.float32),
            "periods": np.clip(np.floor(
                0.1 + 50.0 * feats[:, 18] + 100.0), 33, 255).astype(np.int32),
            "lpc": features[lpc0:lpc0 + frames_per_chunk, _LPC]
            .astype(np.float32),
        })
    order = rng.permutation(len(chunks))
    for b0 in range(0, len(chunks) - batch_size + 1, batch_size):
        sel = order[b0:b0 + batch_size]
        yield {k: np.stack([chunks[i][k] for i in sel]) for k in chunks[0]}
