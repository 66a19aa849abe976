"""Plan T of the sample loop with and without its wr_a ring, on one card.

    python3 tools/plan_t_ablation.py [--batch 1024] [--frames 10] [--reps 3]

Builds csrc/sample_frame.cu a second time with -DLPCNET_ABLATE_RING: plan
T's GRU-A then reads wr_a straight from L2 with __ldg and its producer
warp idles; the consumer layout, the named barriers and the rest of the
step stay (csrc/sample_loop.cuh). Both libraries run the flat frame kernel
under plan T on the same shipped weights, conditions (tests/golden/
ref_feats.f32 tiled over the streams) and state. Prints, for each, the
CUDA-event time per frame in the order ring, ablation, ablation, ring, and
the [phases] split of one frame (us per step, SM clock of the first CTA);
and whether the two give the same bits (pcm and every state leaf). Needs
the CUDA toolkit and a card; the card's name and power limit come first.
"""
import argparse
import contextlib
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, REPO)

from lpcnet_tpu_torch.kernels import _build, sample_cuda  # noqa: E402
from lpcnet_tpu_torch.vocoder import Synthesizer  # noqa: E402

FEATS = os.path.join(REPO, "tests", "golden", "ref_feats.f32")


def build_ablation() -> ctypes.CDLL:
    """csrc/sample_frame.cu with -DLPCNET_ABLATE_RING, built into the build
    directory beside the real library, typed and readied on the card."""
    real = _build.library_path("sample_frame")
    path = real.replace("libsample_frame-", "libsample_frame_ablate-")
    if not os.path.exists(path):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                        "-DLPCNET_ABLATE_RING", "-o", path,
                        os.path.join(_build.CSRC_DIR, "sample_frame.cu")],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(path)
    for fn, argtypes in sample_cuda._ENTRIES["sample_frame"].items():
        entry = getattr(lib, fn)
        entry.argtypes, entry.restype = argtypes, ctypes.c_int
    lib.lpcnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lpcnet_cuda_error_string.restype = ctypes.c_char_p
    n = ctypes.c_int(2 ** 31 - 1)
    sample_cuda._raise_on(lib.lpcnet_prepare_plans(ctypes.byref(n)), lib,
                          "ablation prepare")
    return lib


@contextlib.contextmanager
def frame_library(lib):
    """Inside, the frame kernel's launches go to `lib`."""
    real = sample_cuda._lib
    sample_cuda._lib = lambda name: lib if name == "sample_frame" \
        else real(name)
    try:
        yield
    finally:
        sample_cuda._lib = real


def cuda_ms(fn, reps: int) -> float:
    fn()                                  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plan_t_ablation: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    _build.build(["sample_frame", "synth_samples"])
    ring = sample_cuda._lib("sample_frame")
    ablation = build_ablation()
    B, T = args.batch, args.frames
    v = Synthesizer(device=dev)
    f = np.fromfile(FEATS, np.float32).reshape(-1, 36)
    offs = (np.arange(B) * 7) % (f.shape[0] - T)
    conds = v.conditions(np.stack([f[o:o + T] for o in offs]))
    conds = {k: conds[k].contiguous() for k in ("cond_a", "cond_b", "lpc")}
    st0 = v.reset(B, per_stream_rng=True)
    one = {k: conds[k][:, 0].contiguous() for k in conds}
    out, ms = {}, {}
    with sample_cuda._plan_forced(dev, "T"):
        for name in ("ring", "ablation", "ablation", "ring"):
            lib = ring if name == "ring" else ablation
            with frame_library(lib):
                t = cuda_ms(lambda: sample_cuda.synthesize_frames(
                    v.tables, st0, conds, v.cfg, variant="flat"),
                    args.reps) / T
                ms.setdefault(name, []).append(t)
                if sample_cuda.last_plan[0] != "T":
                    raise RuntimeError(f"plan {sample_cuda.last_plan}")
                print(f"[ablation] plan T B={B} {name}: {t:.4f} ms per "
                      f"frame (CUDA events, {args.reps} x {T} frames) "
                      f"[{card}]")
                if name not in out:
                    out[name] = sample_cuda.synthesize_frames(
                        v.tables, st0, conds, v.cfg, variant="flat")
                    ph = sample_cuda.phase_split(v.tables, st0, one, v.cfg)
                    print(f"[phases] plan T B={B} {name}: "
                          + ", ".join(f"{k} {ph[k]:.3f}"
                                      for k in sample_cuda.PHASES + ("step",))
                          + f" us per step (SM clock {ph['clock_ghz']:.3f} "
                          f"GHz) [{card}]")
    (st_r, pcm_r), (st_a, pcm_a) = out["ring"], out["ablation"]
    same = torch.equal(pcm_r, pcm_a) and all(
        torch.equal(st_r[k], st_a[k]) for k in st_r)
    mean = {k: sum(x) / len(x) for k, x in ms.items()}
    print(f"[ablation] B={B}: ring {mean['ring']:.4f}, ablation "
          f"{mean['ablation']:.4f} ms per frame (mean of two); ablation / "
          f"ring {mean['ablation'] / mean['ring']:.4f}; same bits {same} "
          f"[{card}]")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
