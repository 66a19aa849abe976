"""Feature extraction front end (the port of lpcnet_tpu/features.py;
reference src/lpcnet_enc.c).

A chunk of T frames for B streams is processed as
  1. streaming pre-emphasis                 (lpcnet_enc.c:872-880)
  2. framing + window + FFT + band energies (frame_analysis, :488-496)
     -> log/floor/follower chain -> DCT cepstrum, c0 -= 4   (:512-522)
  3. LPC from cepstrum (freq.c:310-320) -> features[20:36)  (:523-524)
  4. LPC residual ("excitation") via per-frame FIR          (:527-537)
  5. normalized pitch cross-correlation per half-frame, as an FFT
     correlation over 256 lags + 3x sinc-interpolated max   (:539-570)
  6. octave-penalized Viterbi pitch track: a loop over subframes with a
     224-wide path state                                    (:604-635)
  7. backward pass and pitch/corr features: per 4-frame superframe of 8
     subframes with a weighted pitch regression, the codec's mode
     (:636-697), or per frame over its 2 subframes, the streaming mode
     the PLC uses (process_single_frame, :814-870)

All per-frame math is parallel over (B, T); only the Viterbi recursion and
the streaming filters carry state.
"""
from typing import Dict, Tuple

import numpy as np
import torch

from .constants import (FRAME_SIZE, LPC_ORDER, NB_BANDS, OVERLAP_SIZE,
                        PITCH_MAX_PERIOD, PITCH_MIN_PERIOD, PREEMPHASIS,
                        TRAINING_OFFSET, WINDOW_SIZE)
from .ops import dsp
from .ops.tables import device_constant

_NSTATES = PITCH_MAX_PERIOD - PITCH_MIN_PERIOD          # 224
_HALF = FRAME_SIZE // 2                                  # 80
_SEG = PITCH_MAX_PERIOD + _HALF                          # 336 corr segment
_NFFT = 512
# 3x sinc interpolation kernel (lpcnet_enc.c:557)
_INTERP = np.array([0.026184, -0.098339, 0.369938, 0.837891, -0.184969,
                    0.070242, -0.020947], dtype=np.float32)


def _sliding_frames(x: torch.Tensor, n: int, hop: int,
                    width: int) -> torch.Tensor:
    """(B, S) -> (B, n, width) overlapped frames at stride `hop`, zero
    padded past the end of x."""
    need = (n - 1) * hop + width
    if x.shape[1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[1]))
    return x[:, :need].unfold(1, width, hop)


def init_state(batch: int, device=None) -> Dict[str, torch.Tensor]:
    """Fresh analysis state (lpcnet_encoder_init, lpcnet_enc.c:471-475)."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {
        "analysis_mem": z(batch, OVERLAP_SIZE),
        "mem_preemph": z(batch),
        "aligned_hist": z(batch, LPC_ORDER),
        "pitch_filt": z(batch),
        "exc_hist": z(batch, PITCH_MAX_PERIOD),
        "path": z(batch, _NSTATES),
        "path_all": z(batch),
        "best_i": torch.zeros((batch,), dtype=torch.int32, device=device),
        "vq_mem": z(batch, NB_BANDS),
    }


def log_follower(Ly: torch.Tensor) -> torch.Tensor:
    """Per-band log energy with floor + decay follower
    (lpcnet_enc.c:512-520). Ly: (..., 18) raw log10(1e-2 + E)."""
    outs = []
    log_max = torch.full_like(Ly[..., 0], -2.0)
    follow = torch.full_like(Ly[..., 0], -2.0)
    for i in range(NB_BANDS):
        v = torch.maximum(log_max - 8.0,
                          torch.maximum(follow - 2.5, Ly[..., i]))
        log_max = torch.maximum(log_max, v)
        follow = torch.maximum(follow - 2.5, v)
        outs.append(v)
    return torch.stack(outs, dim=-1)


def cepstrum_from_frames(windows: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 320) windowed-input frames -> (cepstrum (B,T,18), bandE)."""
    Ex = dsp.compute_band_energy(
        dsp.forward_transform(dsp.apply_window(windows)))
    ceps = dsp.dct(log_follower(torch.log10(1e-2 + Ex)))
    return torch.cat([ceps[..., :1] - 4.0, ceps[..., 1:]], dim=-1), Ex


def lpc_residual(aligned: torch.Tensor, lpc: torch.Tensor,
                 hist: torch.Tensor, pitch_filt: torch.Tensor):
    """LPC inverse filter + 1-tap smoothing (lpcnet_enc.c:527-537).

    aligned: (B, T, 160) per-frame aligned input; lpc: (B, T, 16);
    hist: (B, 16) previous aligned samples (most recent first);
    pitch_filt: (B,) previous raw sum. Returns (exc (B,T,160), new_hist,
    the raw sums (B, T*160)). exc[s] = sum[s] + .7*sum[s-1] with
    sum[s] = aligned[s] + sum_j lpc[j]*aligned[s-1-j]."""
    B, T, fs = aligned.shape
    flat = aligned.reshape(B, T * fs)
    xp = torch.cat([hist.flip(-1), flat], dim=-1)          # (B, 16 + S)
    # lags[..., j] = aligned[s-1-j]
    lags = torch.stack([xp[:, LPC_ORDER - 1 - j:LPC_ORDER - 1 - j + T * fs]
                        for j in range(LPC_ORDER)], dim=-1)
    lags = lags.reshape(B, T, fs, LPC_ORDER)
    s_flat = (aligned + (lags * lpc[:, :, None, :]).sum(-1)).reshape(
        B, T * fs)
    s_prev = torch.cat([pitch_filt[:, None], s_flat[:, :-1]], dim=-1)
    exc = s_flat + 0.7 * s_prev
    return exc.reshape(B, T, fs), flat[:, -LPC_ORDER:].flip(-1), s_flat


def pitch_xcorr(exc_stream: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized pitch correlation per half-frame (lpcnet_enc.c:539-552).

    exc_stream: (B, 256 + T*160) excitation incl. 256-sample history.
    Returns xc (B, 2T, 256) normalized correlations and the per-subframe
    energy ener0 (B, 2T)."""
    nsub = (exc_stream.shape[1] - PITCH_MAX_PERIOD) // _HALF
    # segments: lags 0..255 + the 80 current samples
    seg = _sliding_frames(exc_stream, nsub, _HALF, _SEG)   # (B, nsub, 336)
    x = seg[..., PITCH_MAX_PERIOD:]                        # (B, nsub, 80)
    # FFT cross-correlation: corr[i] = sum_m x[m] * seg[i + m]
    Fy = torch.fft.rfft(seg, n=_NFFT, dim=-1)
    Fx = torch.fft.rfft(x, n=_NFFT, dim=-1)
    corr = torch.fft.irfft(Fy * torch.conj(Fx), n=_NFFT, dim=-1)[
        ..., :PITCH_MAX_PERIOD].to(torch.float32)
    ener0 = (x * x).sum(-1)                                # (B, nsub)
    c = torch.cumsum(seg * seg, dim=-1)
    # ener1[i] = sum_{j=i}^{i+79} y^2 = c[i+79] - c[i-1]
    hi = c[..., _HALF - 1:_HALF - 1 + PITCH_MAX_PERIOD]
    lo = torch.nn.functional.pad(c[..., :PITCH_MAX_PERIOD - 1], (1, 0))
    xc = 2.0 * corr / (1.0 + ener0[..., None] + (hi - lo))
    # 3x sinc-interpolated max (lpcnet_enc.c:553-570), lags 4..251
    k = device_constant(_INTERP, xc.device)
    pad = torch.nn.functional.pad(xc, (3, 3))
    taps = pad.unfold(-1, 7, 1)                            # (B, nsub, 256, 7)
    val1 = (taps * k.flip(0)).sum(-1)
    val2 = (taps * k).sum(-1)
    interp = torch.maximum(xc, torch.maximum(val1, val2))
    lag = torch.arange(PITCH_MAX_PERIOD, device=xc.device)
    keep = (lag >= 4) & (lag < PITCH_MAX_PERIOD - 4)
    return torch.where(keep, interp, xc), ener0


def _halving_penalty(xc: torch.Tensor) -> torch.Tensor:
    """Penalize lags whose half-lag correlates nearly as well
    (lpcnet_enc.c:607-610). xc: (..., 256). For lag index i < 192 the
    half-lag reads are 128 + i//2, 129 + i//2 and 127 + (i+1)//2."""
    n = PITCH_MAX_PERIOD - 2 * PITCH_MIN_PERIOD            # 192
    i = torch.arange(n, device=xc.device)
    xch = torch.maximum(torch.maximum(xc[..., 128 + i // 2],
                                      xc[..., 129 + i // 2]),
                        xc[..., 127 + (i + 1) // 2])
    head = xc[..., :n]
    return torch.cat([torch.where(head < xch * 1.1, head * 0.8, head),
                      xc[..., n:]], dim=-1)


def viterbi_scan(state: Dict[str, torch.Tensor], xc: torch.Tensor,
                 fw: torch.Tensor):
    """Pitch-track forward pass over subframes (lpcnet_enc.c:604-635).

    xc: (B, nsub, 256); fw: (B, nsub) normalized weights. Carries (path,
    path_all, best_i) in `state`. Returns (new_state, backptr (B, nsub,
    224) int64, best (B, nsub) int32, the penalized xc (B, nsub, 256), and
    the per-subframe paths (nsub, B, 224) and maxima (nsub, B))."""
    B, nsub, _ = xc.shape
    path, path_all, best_prev = (state["path"], state["path_all"],
                                 state["best_i"])
    lane = torch.arange(_NSTATES, device=xc.device)
    bps, bests, xcps, paths, malls = [], [], [], [], []
    for t in range(nsub):
        xcs = _halving_penalty(xc[:, t])
        # candidates: the floor path_all - 6, then j in -4..4: path[i+j] -
        # .02 j^2, out-of-range positions reading -inf
        padded = torch.nn.functional.pad(path, (4, 4), value=float("-inf"))
        cands = [(path_all - 6.0)[:, None].expand(B, _NSTATES)]
        for j in range(-4, 5):
            cands.append(padded[:, j + 4:j + 4 + _NSTATES] - 0.02 * j * j)
        # the C scans the floor first, then j ascending, updating on
        # strictly greater: the first maximum in this stacking order
        max_prev, sel = torch.max(torch.stack(cands, dim=0), dim=0)
        bp = torch.where(sel == 0, best_prev[:, None].long(),
                         torch.clamp(lane + sel - 5, 0, _NSTATES - 1))
        new_path = max_prev + fw[:, t, None] * xcs[:, :_NSTATES]
        mall, best = torch.max(new_path, dim=-1)
        path, path_all, best_prev = (new_path - mall[:, None], mall,
                                     best.to(torch.int32))
        # the C applies the halving penalty in place and the backward pass
        # reads the penalized values (lpcnet_enc.c:641)
        bps.append(bp)
        bests.append(best_prev)
        xcps.append(xcs)
        paths.append(path)
        malls.append(mall)
    new_state = dict(state)
    new_state.update(path=path, path_all=path_all, best_i=best_prev)
    return (new_state, torch.stack(bps, 1), torch.stack(bests, 1),
            torch.stack(xcps, 1), torch.stack(paths), torch.stack(malls))


def _superframe_pitch(bps, bests, xc, fw, quantize: bool):
    """Backward pass and weighted pitch regression for ONE superframe of 8
    subframes (lpcnet_enc.c:636-697).

    bps: (B, 8, 224), bests: (B, 8), xc: (B, 8, 256), fw: (B, 8).
    Returns the superframe's dict: best (B, 8) f32, frame_corr (B,) f32,
    voiced (B,) bool, corr_id, main_pitch, modulation (B,) int32."""
    bi = bests[:, 7].long()
    best = [None] * 8
    corr = torch.zeros_like(fw[:, 0])
    for sub in range(7, -1, -1):
        best[sub] = PITCH_MAX_PERIOD - bi
        corr = corr + fw[:, sub] * xc[:, sub].gather(1, bi[:, None])[:, 0]
        bi = bps[:, sub].gather(1, bi[:, None])[:, 0]
    best = torch.stack(best, dim=1).to(torch.float32)
    frame_corr = corr / 8.0
    if quantize:
        frame_corr = torch.clamp(frame_corr, min=0.0)
    # weighted linear regression, x-coordinates 2..9 (lpcnet_enc.c:650-657)
    x = torch.arange(2.0, 10.0, dtype=torch.float32, device=fw.device)
    sw = fw.sum(1)
    sx = (fw * x).sum(1)
    sxx = (fw * x * x).sum(1)
    sxy = (fw * x * best).sum(1)
    sy = (fw * best).sum(1)
    best_a = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
    voiced = frame_corr >= 0.3
    max_a = sy / sw / 32.0
    best_a = torch.where(voiced, torch.minimum(torch.maximum(best_a, -max_a),
                                               max_a), 0.0)
    corr_id = torch.where(voiced, torch.floor((frame_corr - 0.3) / 0.175),
                          torch.floor(frame_corr / 0.075)).to(torch.int32)
    if quantize:
        frame_corr = torch.where(voiced, 0.3875 + 0.175 * corr_id,
                                 0.0375 + 0.075 * corr_id)
    best_b = (sy - best_a * sx) / sw
    center_pitch = best_b + 5.5 * best_a
    main_pitch = torch.floor(0.5 + 21.0 * 1.442695041 * torch.log(
        center_pitch / PITCH_MIN_PERIOD))
    modulation = torch.floor(0.5 + 16 * 7 * best_a / center_pitch)
    return {"best": best, "frame_corr": frame_corr, "voiced": voiced,
            "corr_id": corr_id,
            "main_pitch": torch.clamp(main_pitch, 0, 63).to(torch.int32),
            "modulation": torch.clamp(modulation, -3, 3).to(torch.int32)}


def quantized_pitch(main_pitch: torch.Tensor,
                    modulation: torch.Tensor) -> torch.Tensor:
    """Pitch feature 18 of a superframe's 4 frames from its quantized
    pitch and modulation (lpcnet_enc.c:687-690, lpcnet_dec.c:110-116):
    (B,) int -> (B, 4)."""
    subs = torch.arange(4, device=main_pitch.device)
    p = torch.pow(2.0, main_pitch.to(torch.float32) / 21.0) \
        * PITCH_MIN_PERIOD
    p = p[:, None] * (1.0 + modulation.to(torch.float32)[:, None]
                      / 16.0 / 7.0 * (2 * subs - 3))
    return 0.02 * (torch.clamp(p, 33.0, 255.0) - 100.0)


def pitch_features(sp: Dict[str, torch.Tensor], quantize: bool):
    """Per-frame pitch/corr features for the 4 frames of a superframe
    (lpcnet_enc.c:685-697). Returns (B, 4, 2)."""
    if quantize:
        f18 = quantized_pitch(sp["main_pitch"], sp["modulation"])
    else:
        pairsum = sp["best"][:, 0::2] + sp["best"][:, 1::2]       # (B, 4)
        f18 = 0.01 * (torch.clamp(pairsum, 66, 510) - 200.0)
    f19 = (sp["frame_corr"] - 0.5)[:, None].expand_as(f18)
    return torch.stack([f18, f19], dim=-1)


def _single_frame_pitch(bps, bests, xcp, fw):
    """Backward pass + features for ONE frame's 2 subframes
    (process_single_frame, lpcnet_enc.c:814-870).

    bps: (B, 2, 224), bests: (B, 2), xcp: (B, 2, 256), fw: (B, 2).
    Returns (B, 2) [pitch_feat, corr_feat]."""
    bi = bests[:, 1].long()
    best = [None, None]
    corr = torch.zeros_like(fw[:, 0])
    for sub in (1, 0):
        best[sub] = (PITCH_MAX_PERIOD - bi).to(torch.float32)
        corr = corr + fw[:, sub] * xcp[:, sub].gather(1, bi[:, None])[:, 0]
        bi = bps[:, sub].gather(1, bi[:, None])[:, 0]
    f18 = 0.01 * (torch.clamp(best[0] + best[1], 66, 510) - 200.0)
    return torch.stack([f18, corr / 2.0 - 0.5], dim=-1)


def compute_features(state: Dict[str, torch.Tensor], pcm: torch.Tensor,
                     quantize_pitch: bool = False, mode: str = "superframe",
                     return_mid: bool = False):
    """Extract features for T frames, batched over streams; the arguments
    and defaults of lpcnet_tpu/features.py::compute_features.

    pcm: (B, T*160) int16-range float. Returns (new_state, features
    (B, T, 36), aux).

    mode="superframe" (T % 4 == 0, the codec's): pitch by the 8-subframe
    Viterbi and a weighted regression per superframe
    (lpcnet_compute_features, lpcnet_enc.c:895-909); aux is the list of
    T // 4 superframe dicts (_superframe_pitch) the codec packs. With
    quantize_pitch the pitch and correlation features are the ones the
    decoder rebuilds from the packet's fields. mode="single": per-frame
    2-subframe pitch (process_single_frame, lpcnet_enc.c:814-870), the
    streaming variant the PLC uses; aux is empty.

    return_mid (mode="single", T >= 2): additionally return the extractor
    state as it stands after the FIRST frame only: (new_state, feats, aux,
    mid_state). A T-frame call equals T serial 1-frame calls, so mid_state
    is the state a 1-frame call would have produced; the PLC step uses this
    to advance on the previous output and analyze the current input in ONE
    pass."""
    if mode not in ("superframe", "single"):
        raise ValueError(f"mode must be 'superframe' or 'single', not "
                         f"{mode!r}")
    B, S = pcm.shape
    T = S // FRAME_SIZE
    if mode == "superframe" and T % 4:
        raise ValueError(f"superframe mode needs whole superframes of 4 "
                         f"frames, not {T} frames")
    if return_mid and (mode != "single" or T < 2):
        raise ValueError("return_mid needs mode='single' and at least 2 "
                         "frames")

    # 1. pre-emphasis
    xp, new_mem = _preemph(pcm, state["mem_preemph"])

    # 2-3. window -> cepstrum -> LPC
    full = torch.cat([state["analysis_mem"], xp], dim=-1)
    windows = _sliding_frames(full, T, FRAME_SIZE, WINDOW_SIZE)
    ceps, _ = cepstrum_from_frames(windows)
    lpc, _ = dsp.lpc_from_cepstrum(ceps)

    # 4. aligned signal (delayed by TRAINING_OFFSET) and LPC residual
    a0 = OVERLAP_SIZE - TRAINING_OFFSET
    aligned_full = full[:, a0:a0 + S]
    exc, new_hist, s_flat = lpc_residual(
        aligned_full.reshape(B, T, FRAME_SIZE), lpc, state["aligned_hist"],
        state["pitch_filt"])

    # 5. pitch correlation, weights normalized per superframe
    # (lpcnet_enc.c:602-603) or per frame (:822-823)
    exc_stream = torch.cat([state["exc_hist"], exc.reshape(B, S)], dim=-1)
    xc, ener0 = pitch_xcorr(exc_stream)           # (B, 2T, 256), (B, 2T)
    group = 8 if mode == "superframe" else 2
    fw = ener0.reshape(B, 2 * T // group, group)
    fw = (fw * (group / (1e-15 + fw.sum(-1, keepdim=True)))).reshape(
        B, 2 * T)

    # 6. Viterbi over all subframes
    new_state = dict(state)
    new_state.update(analysis_mem=xp[:, -OVERLAP_SIZE:], mem_preemph=new_mem,
                     aligned_hist=new_hist, pitch_filt=s_flat[:, -1],
                     exc_hist=exc_stream[:, -PITCH_MAX_PERIOD:])
    new_state, bps, bests, xcp, vpaths, vmalls = viterbi_scan(new_state, xc,
                                                              fw)

    # 7. backward pass + pitch features
    sps = []
    if mode == "superframe":
        for g in range(T // 4):
            sl = slice(8 * g, 8 * (g + 1))
            sps.append(_superframe_pitch(bps[:, sl], bests[:, sl],
                                         xcp[:, sl], fw[:, sl],
                                         quantize_pitch))
        pf = torch.cat([pitch_features(sp, quantize_pitch) for sp in sps],
                       dim=1) if sps else ceps.new_zeros((B, 0, 2))
    else:
        pf = torch.stack([_single_frame_pitch(
            bps[:, 2 * t:2 * t + 2], bests[:, 2 * t:2 * t + 2],
            xcp[:, 2 * t:2 * t + 2], fw[:, 2 * t:2 * t + 2])
            for t in range(T)], dim=1)
    feats = torch.cat([ceps, pf, lpc], dim=-1)
    new_state["vq_mem"] = feats[:, T - 1, :NB_BANDS]
    if return_mid:
        # state after the FIRST frame: every component is a prefix slice of
        # the streaming tensors; the Viterbi carry is the state after
        # subframe 1
        fs = FRAME_SIZE
        mid_state = dict(state)
        mid_state.update(
            analysis_mem=torch.cat([state["analysis_mem"], xp[:, :fs]],
                                   dim=-1)[:, -OVERLAP_SIZE:],
            mem_preemph=-PREEMPHASIS * pcm[:, fs - 1],
            aligned_hist=aligned_full[:, fs - LPC_ORDER:fs].flip(-1),
            pitch_filt=s_flat[:, fs - 1],
            exc_hist=exc_stream[:, fs:fs + PITCH_MAX_PERIOD],
            path=vpaths[1], path_all=vmalls[1], best_i=bests[:, 1],
            vq_mem=feats[:, 0, :NB_BANDS])
        return new_state, feats, sps, mid_state
    return new_state, feats, sps


def _preemph(x: torch.Tensor, mem: torch.Tensor):
    """y[i] = x[i] - coef*x[i-1] with carried memory (lpcnet_enc.c:872-880).
    The C stores mem = -coef*x[i], added to the next sample."""
    y, _ = dsp.preemphasis(x, torch.zeros_like(mem), PREEMPHASIS)
    y = torch.cat([y[..., :1] + mem[..., None], y[..., 1:]], dim=-1)
    return y, -PREEMPHASIS * x[..., -1]
