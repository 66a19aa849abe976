"""Synthesis-quality evaluation of an LPCNet checkpoint on clean speech
(the port of tools/eval_lpcnet.py).

Reports the three numbers of examples/README.md, against a random-init
baseline:
  - pitch-lag autocorrelation at the conditioned period per frame
    (periodicity at the right pitch; random init measures ~0.0)
  - log-spectral correlation against the source audio
  - output RMS against the source RMS (random init clips near full scale)

Usage: python -m lpcnet_tpu_torch.tools.eval_lpcnet ckpt.bin [speech.s16]
       [--device cuda|cpu]
One stream (B=1): on the card the frame kernel under plan L, with --device
cpu the plain loop.
"""
import argparse
import sys

import numpy as np
import torch

from ..constants import FRAME_SIZE
from ..device import resolve_device

CHUNK = 256     # frames per feature call, as the JAX tool's jit chunks


def synth_stats(params, cfg, feats, ref_pcm, nframes, device=None):
    """Synthesize feats (1, T, 36) with params at B=1 and measure the
    output against ref_pcm over frames 2 .. nframes-3. Returns (pitch-lag
    autocorrelation, log-spectral correlation, output RMS)."""
    from ..vocoder import Synthesizer
    voc = Synthesizer(cfg, params=params, device=device)
    _, out = voc.synthesize(voc.reset(1), feats)
    x = out[0].cpu().numpy()
    f = np.asarray(torch.as_tensor(feats).cpu())
    ref = ref_pcm[:len(x)]
    periods = np.clip(np.floor(0.1 + 50 * f[0, :, 18] + 100),
                      33, 255).astype(int)
    acs, sps = [], []
    for t in range(2, nframes - 2):
        seg = x[t * 160:(t + 1) * 160 + 256]
        lag = periods[t]
        if len(seg) > lag + 160 and seg[:160].std() > 1:
            a = np.corrcoef(seg[:160], seg[lag:lag + 160])[0, 1]
            if np.isfinite(a):
                acs.append(a)
        rseg = ref[t * 160:(t + 1) * 160]
        if rseg.std() > 1 and seg[:160].std() > 1:
            ls = np.log10(
                1e3 + np.abs(np.fft.rfft(seg[:160] * np.hanning(160))) ** 2)
            lr = np.log10(
                1e3 + np.abs(np.fft.rfft(rseg * np.hanning(160))) ** 2)
            sps.append(np.corrcoef(ls, lr)[0, 1])
    return float(np.mean(acs)), float(np.mean(sps)), float(x.std())


@torch.no_grad()
def speech_features(pcm: np.ndarray, device) -> torch.Tensor:
    """Superframe features (1, T, 36) of the whole superframes of pcm, in
    CHUNK-frame calls of the feature step (data.feature_step, the JAX
    tool's jitted compute_features) carrying the extractor state."""
    from .. import features as F
    from ..data import feature_step
    step = feature_step(False)
    T = len(pcm) // FRAME_SIZE // 4 * 4
    Tp = -(-T // CHUNK) * CHUNK
    x = np.zeros((1, Tp * FRAME_SIZE), np.float32)
    x[0, :T * FRAME_SIZE] = pcm[:T * FRAME_SIZE]
    x = torch.as_tensor(x, device=device)
    st, parts = F.init_state(1, device), []
    for t0 in range(0, Tp, CHUNK):
        st, f, _ = step(st, x[:, t0 * FRAME_SIZE:(t0 + CHUNK) * FRAME_SIZE])
        parts.append(f)
    return torch.cat(parts, dim=1)[:, :T]


def evaluate(ckpt, speech, device=None):
    """The table of main: [(name, (autocorr, log-spec corr, rms))] for the
    checkpoint and a seed-0 random init over every whole superframe of
    speech, and the reference RMS."""
    from .. import convert
    from ..models import lpcnet
    dev = resolve_device(device)
    pcm = np.fromfile(speech, np.int16).astype(np.float32)
    feats = speech_features(pcm, dev)
    T = feats.shape[1]
    cfg = lpcnet.LPCNetConfig()
    rows = []
    for name, p in (
            (f"trained ({ckpt})", convert.load_lpcnet(ckpt, dev)),
            ("random init", lpcnet.init_params(
                torch.Generator().manual_seed(0), cfg))):
        rows.append((name, synth_stats(p, cfg, feats, pcm, T, dev)))
    return rows, float(pcm[:T * FRAME_SIZE].std())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("speech", nargs="?", default="tests/golden/speech.s16")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain loop)")
    args = ap.parse_args(argv)
    rows, ref_rms = evaluate(args.ckpt, args.speech, args.device)
    for name, (ac, sp, rms) in rows:
        print(f"{name}: pitch-lag autocorr {ac:+.3f}  "
              f"log-spec corr {sp:.3f}  rms {rms:.0f} "
              f"(ref rms {ref_rms:.0f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
