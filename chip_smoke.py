#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lpcnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - nvcc builds every CUDA source of the synthesis path
               (lpcnet_tpu_torch/csrc) into build/lpcnet_tpu_torch/.
  2. path    - the user's entry point, Synthesizer(...).synthesize, on the
               golden reference features tiled over the streams, per-stream
               RNG, shipped weights: B=1024 x 50 frames with the default
               flat sampler, B=1024 x 10 frames with the walked one (base),
               then B=1 x 50 (flat) and B=1 x 10 (base). The launch counts
               are set to 0 just before each run and read just after it.
               Each run is then held against the plain PyTorch sample loop
               (kernels/sample_scan.py) on the card, on the run's own state
               and the first 2 frames of its own conditions, with the gates
               of lpcnet_tpu/verify.py: rng exact, pcm exact fraction >=
               0.95, correlation >= 0.999; the run's pcm must be the
               kernel's on those inputs, and flat and base the same bits
               (pcm, exc, rng). Kernel times by CUDA events.
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
# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth, at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
GATE_EXACT, GATE_CORR = 0.95, 0.999
# (variant, streams, frames) of each main-path run: the default flat sampler
# and the walked one, at the server width and for one stream
PATHS = (("flat", 1024, 50), ("base", 1024, 10), ("flat", 1, 50),
         ("base", 1, 10))
GATE_FRAMES = 2     # frames of each run held against the plain version
TIME_FRAMES = 10    # frames per timed kernel call
NA, NB, NL, FS = 384, 16, 256, 160


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


def frame_bound_ms(batch: int) -> tuple:
    """Least time for one frame of the frame kernel: the larger of its
    float32 operations over the peak rate and the bytes it must move (each
    input once, each output once) over the memory rate."""
    macs = NA * 3 * NA + NA * 3 * NB + NB * 3 * NB + 2 * NB * NL
    flops = 2.0 * macs * FS * batch
    weights = (3 * NL * 3 * NA + NA * 3 * NA + 3 * NA + NA * 3 * NB
               + NB * 3 * NB + 3 * NB + 2 * NB * NL + 4 * NL + 2 * NL) * 4
    per_stream = (3 * NA + 3 * NB + 16) * 4 + 2 * (
        (NA + NB + 16 + 2) * 4 + 4 * 8) + FS * 4
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = (weights + batch * per_stream) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; this test needs "
                    "an NVIDIA card")
    if not os.path.isdir(os.path.join(REPO, "lpcnet_tpu_torch")):
        return fail(f"no lpcnet_tpu_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.kernels import _build, sample_cuda, sample_scan
    from lpcnet_tpu_torch.vocoder import Synthesizer

    # float32 means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    # ---- 1. build
    t0 = time.perf_counter()
    logs = _build.build(["sample_frame"])
    print(f"[build] {time.perf_counter() - t0:.1f} s [{card}]")
    for name, log in logs.items():
        print(f"[build] {name}: {log.strip() or 'already built'}")

    # ---- 2. the main path, each run held against the plain version
    dev = torch.device("cuda")
    params = convert.load_lpcnet(device=dev)
    runs, gates, flat_ref, timing = {}, {}, {}, {}
    for variant, B, frames in PATHS:
        v = Synthesizer(params=params, device=dev, variant=variant)
        cfg, tables = v.cfg, v.tables
        feats = tiled_features(B, frames)
        v.synthesize(v.reset(B, per_stream_rng=True), feats[:, :2])  # warm
        torch.cuda.synchronize()
        for k in sample_cuda.launches:
            sample_cuda.launches[k] = 0
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
        pk, pp = pcm_k.cpu().numpy(), pcm_p.cpu().numpy()
        rng_ok = torch.equal(st_k["rng"], st_p["rng"])
        exact = float((pk == pp).mean())
        corr = float(np.corrcoef(pk.ravel(), pp.ravel())[0, 1])
        err = float(np.abs(pk - pp).max())
        same_state = all(torch.equal(st_k[k], st_p[k]) for k in st_p)
        in_path = torch.equal(pcm[:, :GATE_FRAMES * FS], pcm_k)
        gates[(variant, B)] = {"max_abs_err": err, "exact_frac": exact,
                               "corr": corr, "plain_ms": plain_ms}
        print(f"[kernel] {tag} vs plain ({GATE_FRAMES} frames of this run):"
              f" rng exact {rng_ok}, pcm exact fraction {exact:.6f} (gate >="
              f" {GATE_EXACT}), corr {corr:.8f} (gate >= {GATE_CORR}), max "
              f"|d| {err}, whole state equal {same_state}; the run's pcm is "
              f"the kernel's {in_path}; plain {plain_ms:.1f} ms per frame "
              f"(host clock) [{card}]")
        if not (rng_ok and exact >= GATE_EXACT and corr >= GATE_CORR):
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
        ck = {k: conds[k][:, :TIME_FRAMES].contiguous()
              for k in ("cond_a", "cond_b", "lpc")}
        timing[(variant, B)] = cuda_ms(lambda: sample_cuda.synthesize_frames(
            tables, st0, ck, cfg, variant=variant), 3) / TIME_FRAMES
        print(f"[time] sample_frame_{variant} B={B}: "
              f"{timing[(variant, B)]:.4f} ms per frame (CUDA events), bound "
              f"{frame_bound_ms(B)[0]:.6f} ms ({frame_bound_ms(B)[1]}) "
              f"[{card}]")

    kernels = []
    big = PATHS[0][1]
    bound, bound_by = frame_bound_ms(big)
    for variant, line in (("flat", 469), ("base", 440)):
        g, g1 = gates[(variant, big)], gates[(variant, 1)]
        kernels.append({
            "name": f"sample_frame_{variant}", "route": "cuda",
            "source": "lpcnet_tpu_torch/csrc/sample_frame.cu",
            "replaces": f"lpcnet_tpu/kernels/sample_pallas.py:{line}",
            "launches": runs[(variant, big)],
            "max_abs_err": max(g["max_abs_err"], g1["max_abs_err"]),
            "exact_frac": min(g["exact_frac"], g1["exact_frac"]),
            "corr": min(g["corr"], g1["corr"]),
            "tolerance": "rng exact, pcm exact fraction >= 0.95, corr >= "
                         "0.999",
            "ms": timing[(variant, big)], "plain_ms": g["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "batch": big, "launches_b1": runs[(variant, 1)],
            "ms_b1": timing[(variant, 1)], "plain_ms_b1": g1["plain_ms"],
            "bound_ms_b1": frame_bound_ms(1)[0]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
