#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lpcnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - nvcc builds every CUDA source (lpcnet_tpu_torch/csrc) into
               build/lpcnet_tpu_torch/, one process per source, together.
  2. synthesis - the user's entry point, Synthesizer(...).synthesize, on the
               golden reference features tiled over the streams, per-stream
               RNG, shipped weights: B=1024 x 50 frames with the default
               flat sampler, B=1024 x 4 frames with the walked one (base),
               then B=1 x 50 (flat) and B=1 x 4 (base). The launch counts
               are set to 0 just before each run and read just after it.
               Each run is then held against the plain PyTorch sample loop
               (kernels/sample_scan.py) on the card, on the run's own state
               and the first 2 frames of its own conditions, with the gates
               of lpcnet_tpu/verify.py: rng exact, pcm exact fraction >=
               0.95, correlation >= 0.999; the run's pcm must be the
               kernel's on those inputs, and flat and base the same bits
               (pcm, exc, rng). Kernel times by CUDA events.
  3. plc     - PLCEngine(...).run with the shipped vocoder and PLC weights
               on the golden speech tiled over the streams, per-stream loss
               flags (20%, runs of 1-3 frames): B=1024 x 50 frames and B=1
               x 50 (flat sampler), B=1024 x 10 (base). Exactly one
               synth_samples launch per 10-ms step and no other kernel;
               output finite, int16 range, good rows equal to their input.
  4. noncausal - NonCausalPLCEngine(...).run, B=1024 x 10 frames: 4
               synth_samples and 3 teacher_advance launches per step.
  5. holds   - for every distinct (kernel, argument set, nsamples, batch)
               that phases 3 and 4 launched, the arguments of its last
               launch in the run go through the kernel and through its
               plain version on the card: the gates of phase 2 for
               synth_samples, GRU states to 5e-3 for teacher_advance. The
               argument set with n_active, which no engine of the port
               passes yet, is held on made-up counts; teacher_advance is
               held against a fully forced synth_samples launch.
  6. times   - CUDA-event time per launch of synth_samples (the PLCEngine
               argument set, 160 samples) and of the teacher_advance kernel
               at B=1024 and B=1, the host-side parts of teacher_advance,
               and the PLCEngine step's parts one by one (host clock).
It prints one JSON line of per-kernel numbers, the card's name and power
limit, and last {"ok": true, "device": {...}}. Without a CUDA device, or
without the lpcnet_tpu_torch package beside it, it exits non-zero before
printing any result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FEATS = os.path.join(REPO, "tests", "golden", "ref_feats.f32")
SPEECH = os.path.join(REPO, "tests", "golden", "speech.s16")
# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth, at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
GATE_EXACT, GATE_CORR, GATE_GRU = 0.95, 0.999, 5e-3
TOLERANCE = "rng exact, pcm exact fraction >= 0.95, corr >= 0.999"
# (variant, streams, frames) of each synthesis run: the default flat sampler
# and the walked one, at the server width and for one stream
PATHS = (("flat", 1024, 50), ("base", 1024, 4), ("flat", 1, 50),
         ("base", 1, 4))
# (variant, streams, frames) of each PLCEngine run
PLC_PATHS = (("flat", 1024, 50), ("flat", 1, 50), ("base", 1024, 10))
NONCAUSAL_PATH = (1024, 10)
GATE_FRAMES = 2     # frames of each synthesis run held against the plain one
TIME_FRAMES = 10    # frames per timed kernel call
NA, NB, NL, FS = 384, 16, 256, 160
SOURCES = ("sample_frame", "synth_samples", "teacher_advance")
# multiply-adds per stream and sample: GRU-A recurrent, wi_b, GRU-B
# recurrent; and the dual-FC that only the sample loop has
GRU_MACS = NA * 3 * NA + NA * 3 * NB + NB * 3 * NB
DFC_MACS = 2 * NB * NL
GRU_WEIGHT_FLOATS = (3 * NL * 3 * NA + NA * 3 * NA + 3 * NA + NA * 3 * NB
                     + NB * 3 * NB + 3 * NB)
STATE_FLOATS = NA + NB + 16 + 2 + 8     # rng: 4 int64


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def tiled_features(batch: int, frames: int) -> np.ndarray:
    """The golden reference features, one window per stream at its own
    offset, so the streams differ."""
    f = np.fromfile(FEATS, np.float32).reshape(-1, 36)
    n = f.shape[0] - frames
    offs = (np.arange(batch) * 7) % n
    return np.stack([f[o:o + frames] for o in offs])


def tiled_speech(batch: int, frames: int) -> np.ndarray:
    """The golden speech, one window per stream at its own offset."""
    x = np.fromfile(SPEECH, np.int16).astype(np.float32)
    n = len(x) - frames * FS
    offs = (np.arange(batch) * 37) % n
    return np.stack([x[o:o + frames * FS] for o in offs])


def loss_flags(batch: int, frames: int) -> np.ndarray:
    """Per-stream loss flags from numpy.random.default_rng(0): runs of 1-3
    lost frames, started so that about 20% of the frames are lost."""
    rng = np.random.default_rng(0)
    lost = np.zeros((batch, frames), bool)
    left = np.zeros(batch, np.int64)
    for t in range(frames):
        start = (left == 0) & (rng.random(batch) < 0.125)
        left = np.where(start, rng.integers(1, 4, batch), left)
        lost[:, t] = left > 0
        left = np.maximum(left - 1, 0)
    return lost


def sample_bound_ms(batch: int, ns: int, forced: bool) -> tuple:
    """Least time for one launch of the sample loop over ns samples: the
    larger of its float32 operations over the peak rate and the bytes it
    must move (each input once, each output once) over the memory rate."""
    flops = 2.0 * (GRU_MACS + DFC_MACS) * ns * batch
    weights = (GRU_WEIGHT_FLOATS + 2 * NB * NL + 4 * NL + 2 * NL) * 4
    per_stream = (3 * NA + 3 * NB + 16) * 4 + 2 * STATE_FLOATS * 4 + ns * 4
    if forced:
        per_stream += ns * 4 + 8          # target, preload, force_from
    return _bound(flops, weights + batch * per_stream)


def teacher_bound_ms(batch: int, ns: int) -> tuple:
    """The same for the teacher_advance kernel: no dual-FC, and its inputs
    are the conditions, three index rows and the two GRU states."""
    flops = 2.0 * GRU_MACS * ns * batch
    per_stream = (3 * NA + 3 * NB) * 4 + 3 * ns * 4 + 2 * (NA + NB) * 4
    return _bound(flops, GRU_WEIGHT_FLOATS * 4 + batch * per_stream)


def _bound(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()                                  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host clock around reps calls, synchronised before and after."""
    import torch
    fn()                                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def compare_pcm(pcm_k, pcm_p) -> dict:
    pk, pp = pcm_k.cpu().numpy(), pcm_p.cpu().numpy()
    corr = float(np.corrcoef(pk.ravel(), pp.ravel())[0, 1]) \
        if pk.std() > 0 and pp.std() > 0 else float(np.array_equal(pk, pp))
    return {"max_abs_err": float(np.abs(pk - pp).max()),
            "exact_frac": float((pk == pp).mean()), "corr": corr}


class Recorder:
    """Stands in for sample_cuda.synth_samples and teacher_gru_advance while
    an engine runs: passes every call through and keeps the arguments of
    the last call of each distinct (kernel, argument set, nsamples,
    batch)."""

    def __init__(self, sample_cuda):
        self.mod = sample_cuda
        self.calls = {}
        self._synth = sample_cuda.synth_samples
        self._teacher = sample_cuda.teacher_gru_advance

    def __enter__(self):
        self.mod.synth_samples = self.synth_samples
        self.mod.teacher_gru_advance = self.teacher_gru_advance
        return self

    def __exit__(self, *exc):
        self.mod.synth_samples = self._synth
        self.mod.teacher_gru_advance = self._teacher

    def synth_samples(self, tables, state, cond, cfg, nsamples, **kw):
        given = tuple(k for k in ("target", "preload", "force_from",
                                  "n_active") if kw.get(k) is not None)
        key = ("tf_" + kw.get("variant", "flat"), given, nsamples,
               cond["cond_a"].shape[0])
        self.calls[key] = (tables, state, cond, cfg, nsamples, kw)
        return self._synth(tables, state, cond, cfg, nsamples, **kw)

    def teacher_gru_advance(self, tables, gru_a, gru_b, cond, seqs, cfg):
        key = ("teacher", (), seqs["lsu"].shape[1], cond["cond_a"].shape[0])
        self.calls[key] = (tables, gru_a, gru_b, cond, seqs, cfg)
        return self._teacher(tables, gru_a, gru_b, cond, seqs, cfg)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; this test needs "
                    "an NVIDIA card")
    if not os.path.isdir(os.path.join(REPO, "lpcnet_tpu_torch")):
        return fail(f"no lpcnet_tpu_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    from lpcnet_tpu_torch import convert, features, plc
    from lpcnet_tpu_torch.kernels import _build, sample_cuda, sample_scan
    from lpcnet_tpu_torch.models import lpcnet as lpcnet_model
    from lpcnet_tpu_torch.models import plc as plc_model
    from lpcnet_tpu_torch.ops import burg, kiss99
    from lpcnet_tpu_torch.vocoder import Synthesizer

    # float32 means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    def zero_counts():
        for k in sample_cuda.launches:
            sample_cuda.launches[k] = 0

    # ---- 1. build
    t0 = time.perf_counter()
    logs = _build.build(SOURCES)
    print(f"[build] {time.perf_counter() - t0:.1f} s [{card}]")
    for name, log in logs.items():
        print(f"[build] {name}: {log.strip() or 'already built'}")

    # ---- 2. the synthesis path, each run held against the plain version
    dev = torch.device("cuda")
    params = convert.load_lpcnet(device=dev)
    runs, gates, flat_ref, timing = {}, {}, {}, {}
    for variant, B, frames in PATHS:
        v = Synthesizer(params=params, device=dev, variant=variant)
        cfg, tables = v.cfg, v.tables
        feats = tiled_features(B, frames)
        v.synthesize(v.reset(B, per_stream_rng=True), feats[:, :2])  # warm
        torch.cuda.synchronize()
        zero_counts()
        st0 = v.reset(B, per_stream_rng=True)
        t0 = time.perf_counter()
        st, pcm = v.synthesize(st0, feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sample_cuda.launches)
        p = pcm.cpu().numpy()
        tag = f"{variant} B={B}"
        print(f"[path] {tag} x {frames} frames: launches {counts}, pcm "
              f"{p.shape}, finite {bool(np.isfinite(p).all())}, max |pcm| "
              f"{np.abs(p).max()}")
        if counts[variant] != frames or sum(counts.values()) != frames:
            return fail(f"{tag}: expected {frames} {variant} launches, got "
                        f"{counts}")
        if p.shape != (B, frames * FS) or not np.isfinite(p).all() \
                or np.abs(p).max() > 32767:
            return fail(f"{tag}: pcm is not finite int16-range audio")
        runs[(variant, B)] = counts[variant]
        print(f"[path] {tag}: {wall * 1e3 / frames:.4f} ms per frame (host "
              f"clock, with conditioning), RT factor "
              f"{B * frames * 0.01 / wall:.1f}x [{card}]")

        # the kernel and its plain version on this run's own state and
        # conditions (its first GATE_FRAMES frames); these launches come
        # after the count was read
        conds = v.conditions(feats)
        c = {k: conds[k][:, :GATE_FRAMES].contiguous()
             for k in ("cond_a", "cond_b", "lpc")}
        st_k, pcm_k = sample_cuda.synthesize_frames(tables, st0, c, cfg,
                                                    variant=variant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, pcm_p = sample_scan.synthesize_frames(
            tables, st0, c, cfg, flat=variant == "flat")
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / GATE_FRAMES
        rng_ok = torch.equal(st_k["rng"], st_p["rng"])
        g = compare_pcm(pcm_k, pcm_p)
        same_state = all(torch.equal(st_k[k], st_p[k]) for k in st_p)
        in_path = torch.equal(pcm[:, :GATE_FRAMES * FS], pcm_k)
        gates[(variant, B)] = {**g, "plain_ms": plain_ms}
        print(f"[kernel] {tag} vs plain ({GATE_FRAMES} frames of this run):"
              f" rng exact {rng_ok}, pcm exact fraction "
              f"{g['exact_frac']:.6f} (gate >= {GATE_EXACT}), corr "
              f"{g['corr']:.8f} (gate >= {GATE_CORR}), max |d| "
              f"{g['max_abs_err']}, whole state equal {same_state}; the "
              f"run's pcm is the kernel's {in_path}; plain {plain_ms:.1f} ms"
              f" per frame (host clock) [{card}]")
        if not (rng_ok and g["exact_frac"] >= GATE_EXACT
                and g["corr"] >= GATE_CORR):
            return fail(f"{tag}: kernel disagrees with the plain version")
        if not in_path:
            return fail(f"{tag}: the run's pcm differs from the kernel's on "
                        f"the same inputs")

        # flat and base on the same inputs give the same bits
        if variant == "flat":
            flat_ref[B] = (tables, st0, c, st_k, pcm_k)
        else:
            tf, s0, cf, sf, pf = flat_ref[B]
            sb, pb = sample_cuda.synthesize_frames(tf, s0, cf, cfg,
                                                   variant="base")
            same = (torch.equal(pf, pb)
                    and torch.equal(sf["last_exc"], sb["last_exc"])
                    and torch.equal(sf["rng"], sb["rng"]))
            print(f"[kernel] B={B}: flat vs base bit-identical (pcm, exc, "
                  f"rng): {same}")
            if not same:
                return fail(f"B={B}: flat and base kernels differ")

        # the kernel alone, per frame, on this run's conditions
        nt = min(TIME_FRAMES, frames)
        ck = {k: conds[k][:, :nt].contiguous()
              for k in ("cond_a", "cond_b", "lpc")}
        timing[(variant, B)] = cuda_ms(lambda: sample_cuda.synthesize_frames(
            tables, st0, ck, cfg, variant=variant), 3) / nt
        bound = sample_bound_ms(B, FS, False)
        print(f"[time] sample_frame_{variant} B={B}: "
              f"{timing[(variant, B)]:.4f} ms per frame (CUDA events), bound "
              f"{bound[0]:.6f} ms ({bound[1]}) [{card}]")

    # ---- 3. the PLC path: PLCEngine.run, one K3 launch per step
    plc_params = convert.load_plc(device=dev)
    calls, plc_runs, engines = {}, {}, {}
    for variant, B, frames in PLC_PATHS:
        eng = plc.PLCEngine(params, plc_params, device=dev, variant=variant)
        pcm_in, lost = tiled_speech(B, frames), loss_flags(B, frames)
        eng.run(eng.init_state(B), pcm_in[:, :2 * FS], lost[:, :2])  # warm
        torch.cuda.synchronize()
        zero_counts()
        with Recorder(sample_cuda) as rec:
            t0 = time.perf_counter()
            st, out = eng.run(eng.init_state(B), pcm_in, lost)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(sample_cuda.launches)
        calls.update(rec.calls)
        o = out.cpu().numpy()
        tag = f"PLCEngine {variant} B={B}"
        blend = np.concatenate([np.zeros((B, 1), bool), lost[:, :-1]], 1) \
            & ~lost
        good = np.repeat(~lost & ~blend, FS, axis=1)
        print(f"[plc] {tag} x {frames} frames: launches {counts}; lost "
              f"{lost.mean():.3f} of the frames, blend {blend.mean():.3f}; "
              f"out {o.shape}, finite {bool(np.isfinite(o).all())}, max "
              f"|out| {np.abs(o).max()}, good rows equal input "
              f"{bool((o[good] == pcm_in[good]).all())}")
        if counts["tf_" + variant] != frames \
                or sum(counts.values()) != frames:
            return fail(f"{tag}: expected {frames} tf_{variant} launches and"
                        f" nothing else, got {counts}")
        if o.shape != (B, frames * FS) or not np.isfinite(o).all() \
                or np.abs(o).max() > 32767:
            return fail(f"{tag}: output is not finite int16-range audio")
        if not (o[good] == pcm_in[good]).all():
            return fail(f"{tag}: a good frame did not pass through")
        if B > 1 and not (lost.any(1).any() and np.abs(o[~good]).max() > 0):
            return fail(f"{tag}: nothing was concealed")
        plc_runs[(variant, B)] = counts["tf_" + variant]
        engines[(variant, B)] = (eng, st, pcm_in, lost)
        print(f"[plc] {tag}: {wall * 1e3 / frames:.4f} ms per step (host "
              f"clock, synchronised at the end), RT factor "
              f"{B * frames * 0.01 / wall:.1f}x [{card}]")

    # ---- 4. the non-causal path: 4 K3 and 3 K4 launches per step
    B, frames = NONCAUSAL_PATH
    nc = plc.NonCausalPLCEngine(params, plc_params, device=dev)
    pcm_in, lost = tiled_speech(B, frames), loss_flags(B, frames)
    nc.run(nc.init_state(B), pcm_in[:, :FS], lost[:, :1])            # warm
    torch.cuda.synchronize()
    zero_counts()
    with Recorder(sample_cuda) as rec:
        t0 = time.perf_counter()
        st, out = nc.run(nc.init_state(B), pcm_in, lost)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(sample_cuda.launches)
    calls.update(rec.calls)
    o = out.cpu().numpy()
    clean = ~lost.any(1)
    delayed_ok = bool((o[clean, 80:] == pcm_in[clean, :-80]).all())
    print(f"[noncausal] NonCausalPLCEngine B={B} x {frames} frames: launches"
          f" {counts}; out {o.shape}, finite {bool(np.isfinite(o).all())}, "
          f"max |out| {np.abs(o).max()}; {int(clean.sum())} streams without "
          f"a loss equal their input delayed by 80 samples: {delayed_ok}")
    if counts != {"flat": 0, "base": 0, "tf_flat": 4 * frames, "tf_base": 0,
                  "teacher": 3 * frames}:
        return fail(f"noncausal: expected {4 * frames} tf_flat and "
                    f"{3 * frames} teacher launches, got {counts}")
    if o.shape != (B, frames * FS) or not np.isfinite(o).all() \
            or np.abs(o).max() > 32767 or not delayed_ok:
        return fail("noncausal: output is not the expected audio")
    nc_counts = counts
    print(f"[noncausal] {wall * 1e3 / frames:.4f} ms per step (host clock), "
          f"RT factor {B * frames * 0.01 / wall:.1f}x [{card}]")

    # ---- 5. every launched (kernel, argument set, nsamples, batch) held
    # against its plain version on the last launch's own arguments
    held = {"tf_flat": [], "tf_base": [], "teacher": []}

    def hold_synth(tag, tables, state, cond, cfg, ns, kw):
        kw = dict(kw)
        variant = kw.pop("variant", "flat")
        st_k, pcm_k = sample_cuda.synth_samples(tables, state, cond, cfg, ns,
                                                variant=variant, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, pcm_p = sample_scan.synth_samples(
            tables, state, cond, cfg, ns, flat=variant == "flat", **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        g = compare_pcm(pcm_k, pcm_p)
        rng_ok = torch.equal(st_k["rng"], st_p["rng"])
        same = torch.equal(pcm_k, pcm_p) and all(
            torch.equal(st_k[k], st_p[k]) for k in st_p)
        print(f"[hold] {tag}: rng exact {rng_ok}, pcm exact fraction "
              f"{g['exact_frac']:.6f}, corr {g['corr']:.8f}, max |d| "
              f"{g['max_abs_err']}; bit-identical (pcm and every state "
              f"leaf): {same}; plain {plain_ms:.1f} ms (host clock) "
              f"[{card}]")
        ok = rng_ok and g["exact_frac"] >= GATE_EXACT \
            and g["corr"] >= GATE_CORR
        held["tf_" + variant].append({**g, "plain_ms": plain_ms, "ns": ns,
                                      "batch": cond["cond_a"].shape[0]})
        return ok

    for key in sorted(calls, key=str):
        name, given, ns, B = key
        tag = (f"{name} ({'+'.join(given) or 'free-run'}, ns={ns}, B={B}) "
               f"vs plain")
        if name == "teacher":
            tables, gru_a, gru_b, cond, seqs, cfg = calls[key]
            ka, kb = sample_cuda.teacher_gru_advance(tables, gru_a, gru_b,
                                                     cond, seqs, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pa, pb = sample_scan.teacher_gru_advance(tables, gru_a, gru_b,
                                                     cond, seqs, cfg)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(float((ka - pa).abs().max()),
                      float((kb - pb).abs().max()))
            same = torch.equal(ka, pa) and torch.equal(kb, pb)
            print(f"[hold] {tag}: GRU states max |d| {err} (gate < "
                  f"{GATE_GRU}); bit-identical: {same}; plain "
                  f"{plain_ms:.1f} ms (host clock) [{card}]")
            held["teacher"].append({"max_abs_err": err, "plain_ms": plain_ms,
                                    "ns": ns, "batch": B})
            if not err < GATE_GRU:
                return fail(f"{tag}: GRU states disagree")
        elif not hold_synth(tag, *calls[key]):
            return fail(f"{tag}: kernel disagrees with the plain version")

    # the argument set with n_active (target + force_from + n_active, as
    # lpcnet_tpu/verify.py holds it), on made-up counts and the state and
    # conditions of the PLC run's last launch
    big = PLC_PATHS[0][1]
    tables, state, cond, cfg, ns, kw = calls[
        ("tf_flat", ("target", "force_from"), FS, big)]
    rs = np.random.RandomState(7)
    made_up = dict(kw, force_from=torch.as_tensor(
        rs.randint(40, FS, big), dtype=torch.int32, device=dev),
        n_active=torch.as_tensor(rs.randint(0, FS + 1, big),
                                 dtype=torch.int32, device=dev))
    if not hold_synth(f"tf_flat (target+force_from+n_active made up, ns="
                      f"{ns}, B={big}) vs plain", tables, state, cond, cfg,
                      ns, made_up):
        return fail("n_active: kernel disagrees with the plain version")

    # K4 against a fully forced K3 launch, both through their wrappers
    target = kw["target"]
    st4, _ = sample_cuda.teacher_advance(tables, state, cond, cfg, target)
    st3, pcm3 = sample_cuda.synth_samples(tables, state, cond, cfg, ns,
                                          target=target)
    leaves = {k: torch.equal(st4[k], st3[k]) for k in st3}
    print(f"[hold] teacher_advance vs fully forced synth_samples (ns={ns}, "
          f"B={big}): every state leaf equal {all(leaves.values())} "
          f"{leaves}; forced pcm is the target "
          f"{torch.equal(pcm3, target)}")
    gru_err = max(float((st4[k] - st3[k]).abs().max())
                  for k in ("gru_a", "gru_b"))
    if not (gru_err < GATE_GRU and torch.equal(pcm3, target) and all(
            leaves[k] for k in ("last_sig", "last_exc", "deemph", "rng"))):
        return fail("teacher_advance disagrees with forced synth_samples")

    # ---- 6. times
    ktime = {}
    for B in (big, 1):
        for variant in ("flat", "base"):
            key = ("tf_" + variant, ("target", "force_from"), FS, B)
            if key not in calls:
                continue
            tables, state, cond, cfg, ns, kw = calls[key]
            ktime[("tf_" + variant, B)] = cuda_ms(
                lambda: sample_cuda.synth_samples(tables, state, cond, cfg,
                                                  ns, **kw), 5)
            bound = sample_bound_ms(B, ns, True)
            print(f"[time] synth_samples_{variant} (target+force_from, "
                  f"ns={ns}) B={B}: {ktime[('tf_' + variant, B)]:.4f} ms per"
                  f" launch (CUDA events), bound {bound[0]:.6f} ms "
                  f"({bound[1]}) [{card}]")
        tables, state, cond, cfg, ns, kw = calls[
            ("tf_flat", ("target", "force_from"), FS, B)]
        target = kw["target"]
        seqs = sample_scan.teacher_sequences(state, cond, cfg, target)
        ktime[("teacher", B)] = cuda_ms(
            lambda: sample_cuda.teacher_gru_advance(
                tables, state["gru_a"], state["gru_b"], cond, seqs, cfg), 5)
        t_seq = host_ms(lambda: sample_scan.teacher_sequences(
            state, cond, cfg, target), 3)
        t_rng = host_ms(lambda: kiss99.kiss99_advance(state["rng"], 2 * ns),
                        3)
        t_all = host_ms(lambda: sample_cuda.teacher_advance(
            tables, state, cond, cfg, target), 3)
        bound = teacher_bound_ms(B, ns)
        print(f"[time] teacher_advance kernel (ns={ns}) B={B}: "
              f"{ktime[('teacher', B)]:.4f} ms per launch (CUDA events), "
              f"bound {bound[0]:.6f} ms ({bound[1]}); around it, host "
              f"clock: teacher_sequences {t_seq:.3f} ms, kiss99_advance "
              f"{t_rng:.3f} ms, the whole teacher_advance call {t_all:.3f} "
              f"ms [{card}]")

    # the PLCEngine step's parts, one by one, on the last step's inputs
    for B in (big, 1):
        eng, st, pcm_in, lost = engines[("flat", B)]
        fr = torch.as_tensor(pcm_in[:, -FS:], device=dev)
        lo = torch.as_tensor(lost[:, -1], device=dev)
        tables, state, cond, cfg, ns, kw = calls[
            ("tf_flat", ("target", "force_from"), FS, B)]
        feats36 = torch.zeros((B, 36), device=dev)
        x57 = torch.zeros((2 * B, plc_model.PLC_INPUT_SIZE), device=dev)
        net2 = {k: torch.cat([v, v]) for k, v in st["plc_net"].items()}
        parts = {
            "burg": lambda: burg.burg_cepstral_analysis(fr),
            "features(2 frames)": lambda: features.compute_features(
                st["enc"], torch.cat([st["prev_out"], fr], -1),
                return_mid=True),
            "plc_net(2B rows)": lambda: plc_model.step(
                eng.plc_params, net2, x57, eng.plc_cfg),
            "frame_net_step": lambda: lpcnet_model.frame_net_step(
                eng.params, eng.tables, st["fnet"], feats36, eng.cfg),
            "synth_samples": lambda: sample_cuda.synth_samples(
                tables, state, cond, cfg, ns, **kw),
            "whole step": lambda: eng.step(st, fr, lo),
        }
        split = {k: host_ms(fn, 5) for k, fn in parts.items()}
        print(f"[split] PLCEngine step B={B}, each part alone, ms (host "
              f"clock, synchronised): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f" [{card}]")

    # ---- the kernels' line
    kernels = []
    big = PATHS[0][1]
    bound, bound_by = sample_bound_ms(big, FS, False)
    for variant, line in (("flat", 469), ("base", 440)):
        g, g1 = gates[(variant, big)], gates[(variant, 1)]
        kernels.append({
            "name": f"sample_frame_{variant}", "route": "cuda",
            "source": "lpcnet_tpu_torch/csrc/sample_frame.cu",
            "replaces": f"lpcnet_tpu/kernels/sample_pallas.py:{line}",
            "launches": runs[(variant, big)],
            "max_abs_err": max(g["max_abs_err"], g1["max_abs_err"]),
            "exact_frac": min(g["exact_frac"], g1["exact_frac"]),
            "corr": min(g["corr"], g1["corr"]), "tolerance": TOLERANCE,
            "ms": timing[(variant, big)], "plain_ms": g["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "batch": big, "launches_b1": runs[(variant, 1)],
            "ms_b1": timing[(variant, 1)], "plain_ms_b1": g1["plain_ms"],
            "bound_ms_b1": sample_bound_ms(1, FS, False)[0]})
    bound, bound_by = sample_bound_ms(big, FS, True)
    for variant, line in (("flat", 569), ("base", 529)):
        hs = held["tf_" + variant]
        launches = plc_runs[(variant, big)]
        row = {
            "name": f"synth_samples_{variant}", "route": "cuda",
            "source": "lpcnet_tpu_torch/csrc/synth_samples.cu",
            "replaces": f"lpcnet_tpu/kernels/sample_pallas.py:{line}",
            "launches": launches,
            "max_abs_err": max(h["max_abs_err"] for h in hs),
            "exact_frac": min(h["exact_frac"] for h in hs),
            "corr": min(h["corr"] for h in hs), "tolerance": TOLERANCE,
            "ms": ktime[("tf_" + variant, big)],
            "plain_ms": max(h["plain_ms"] for h in hs
                            if h["ns"] == FS and h["batch"] == big),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "batch": big, "held_argument_sets": len(hs)}
        if variant == "flat":
            row.update(launches_noncausal=nc_counts["tf_flat"],
                       launches_b1=plc_runs[("flat", 1)],
                       ms_b1=ktime[("tf_flat", 1)],
                       bound_ms_b1=sample_bound_ms(1, FS, True)[0])
        kernels.append(row)
    bound, bound_by = teacher_bound_ms(big, FS)
    hs = held["teacher"]
    kernels.append({
        "name": "teacher_advance", "route": "cuda",
        "source": "lpcnet_tpu_torch/csrc/teacher_advance.cu",
        "replaces": "lpcnet_tpu/kernels/sample_pallas.py:610",
        "launches": nc_counts["teacher"],
        "max_abs_err": max(h["max_abs_err"] for h in hs),
        "tolerance": f"GRU states to {GATE_GRU}",
        "ms": ktime[("teacher", big)],
        "plain_ms": max(h["plain_ms"] for h in hs),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "batch": big, "ms_b1": ktime[("teacher", 1)],
        "bound_ms_b1": teacher_bound_ms(1, FS)[0]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
