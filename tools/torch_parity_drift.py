"""Free-run drift between the JAX package's two sample loops and the
PyTorch port's plain loop, on the CPU, with the shipped weights.

    JAX_PLATFORMS=cpu python tools/torch_parity_drift.py [--batch 64]
        [--frames 2] [--offsets tiled|seeded] [--seed 0]

Each stream synthesizes `frames` frames of tests/golden/ref_feats.f32 from
its own offset (tiled: 7*i, the layout of chip_smoke.py; seeded: uniform
from --seed), per-stream RNG. Three loops run on the same conditions and
state:
  scan   lpcnet_tpu.kernels.sample_scan.synthesize_frames (lax.scan)
  pallas lpcnet_tpu.kernels.sample_pallas.synthesize_frames_pallas
         (interpret mode, flat sampler)
  port   lpcnet_tpu_torch.kernels.sample_scan.synthesize_frames (flat)
and the port's Synthesizer(device="cpu") runs end to end (its own
conditioning) against the JAX Synthesizer(backend="scan").

For each pair it prints the gate of lpcnet_tpu/verify.py (rng exact, pcm
exact fraction, correlation) and the streams that drift: those with a
sample more than 1 apart (a rounding difference of floor(.5+x) is 1), with
the first such sample. Each stream on which the port drifts from JAX scan
is then run through JAX scan alone (B=1). If JAX drifts against itself on
the same streams (between loops, or between batch sizes), the drift is the
loop's sensitivity to float near-ties, not a fault of the port.
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lpcnet_tpu.kernels import sample_pallas, sample_scan as j_scan  # noqa
from lpcnet_tpu.utils import weights_io as j_wio  # noqa: E402
from lpcnet_tpu.vocoder import Synthesizer as JSynthesizer  # noqa: E402
from lpcnet_tpu_torch import convert  # noqa: E402
from lpcnet_tpu_torch.kernels import sample_scan as t_scan  # noqa: E402
from lpcnet_tpu_torch.vocoder import Synthesizer  # noqa: E402

WEIGHTS = os.path.join(REPO, "examples", "speech_lpcnet_params.bin")
FEATS = os.path.join(REPO, "tests", "golden", "ref_feats.f32")


def features(batch, frames, offsets, seed):
    f = np.fromfile(FEATS, np.float32).reshape(-1, 36)
    n = f.shape[0] - frames
    if offsets == "tiled":
        offs = (np.arange(batch) * 7) % n
    else:
        offs = np.random.RandomState(seed).randint(0, n, batch)
    return np.stack([f[o:o + frames] for o in offs]), offs


def compare(name, pcm, ref, rng, ref_rng):
    pcm, ref = np.asarray(pcm, np.float64), np.asarray(ref, np.float64)
    rng_ok = np.array_equal(np.asarray(rng).astype(np.int64),
                            np.asarray(ref_rng).astype(np.int64))
    exact = float((pcm == ref).mean())
    corr = float(np.corrcoef(pcm.ravel(), ref.ravel())[0, 1])
    far = np.abs(pcm - ref) > 1
    drift = {int(b): int(np.argmax(far[b])) for b in np.nonzero(
        far.any(axis=1))[0]}
    print(f"{name}: rng exact {rng_ok}, pcm exact fraction {exact:.6f}, "
          f"corr {corr:.8f}, drifting streams {{stream: first sample}} "
          f"{drift}")
    return drift


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--offsets", choices=("tiled", "seeded"), default="tiled")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    feats, offs = features(a.batch, a.frames, a.offsets, a.seed)
    print(f"B={a.batch}, T={a.frames}, offsets {a.offsets}: {offs.tolist()}")

    params = jax.tree.map(jnp.asarray, j_wio.load_params(WEIGHTS))
    jv = JSynthesizer(params=params, backend="scan")
    state = jv.reset(a.batch, per_stream_rng=True)
    conds = jv.conditions(jnp.asarray(feats))
    t0 = time.perf_counter()
    st_s, pcm_s = j_scan.synthesize_frames(jv.tables, state, conds, jv.cfg)
    pcm_s = np.asarray(pcm_s)
    t1 = time.perf_counter()
    st_p, pcm_p = sample_pallas.synthesize_frames_pallas(
        jv.tables, state, conds, jv.cfg, interpret=True, variant="flat")
    pcm_p = np.asarray(pcm_p)
    t2 = time.perf_counter()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    tv = Synthesizer(params=tparams, device="cpu")
    tstate = {k: torch.as_tensor(np.asarray(v).astype(
        np.int64 if k == "rng" else np.asarray(v).dtype))
        for k, v in state.items()}
    tconds = {k: torch.as_tensor(np.array(conds[k]))
              for k in ("cond_a", "cond_b", "lpc")}
    st_t, pcm_t = t_scan.synthesize_frames(tv.tables, tstate, tconds, tv.cfg,
                                           flat=True)
    t3 = time.perf_counter()
    st_e, pcm_e = tv.synthesize(tv.reset(a.batch, per_stream_rng=True), feats)
    st_je, pcm_je = jv.synthesize(jv.reset(a.batch, per_stream_rng=True),
                                  jnp.asarray(feats))
    print(f"seconds: scan {t1 - t0:.1f}, pallas interpret {t2 - t1:.1f}, "
          f"port loop {t3 - t2:.1f}")

    d_sp = compare("jax scan vs jax pallas (same conditions)", pcm_p, pcm_s,
                   st_p["rng"], st_s["rng"])
    d_ts = compare("port loop vs jax scan (same conditions)", pcm_t.numpy(),
                   pcm_s, st_t["rng"].numpy(), st_s["rng"])
    compare("port loop vs jax pallas (same conditions)", pcm_t.numpy(), pcm_p,
            st_t["rng"].numpy(), st_p["rng"])
    compare("port Synthesizer vs jax Synthesizer scan (end to end)",
            pcm_e.numpy(), np.asarray(pcm_je), st_e["rng"].numpy(),
            st_je["rng"])
    own = sorted(set(d_ts) - set(d_sp))
    print(f"streams where the port drifts from scan but pallas does not: "
          f"{own}")
    # The port's sums run in one order whatever the batch; XLA's CPU dot may
    # not. Run JAX scan again on each drifting stream alone.
    for b in sorted(d_ts):
        one = {k: v[b:b + 1] for k, v in state.items()}
        c1 = {k: v[b:b + 1] for k, v in conds.items()}
        st_1, pcm_1 = j_scan.synthesize_frames(jv.tables, one, c1, jv.cfg)
        compare(f"stream {b}: jax scan alone (B=1) vs jax scan in the batch "
                f"(B={a.batch})", pcm_1, pcm_s[b:b + 1], st_1["rng"],
                st_s["rng"][b:b + 1])
        compare(f"stream {b}: port loop in the batch vs jax scan alone (B=1)",
                pcm_t.numpy()[b:b + 1], pcm_1, st_t["rng"].numpy()[b:b + 1],
                st_1["rng"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
