"""Benchmark of the port: batched LPCNet pipeline throughput on one card
(the counterpart of the repo's bench.py, with its metric names).

    python -m lpcnet_tpu_torch.bench [--verify] [--device cuda|cpu]

Headline metric (always printed, LAST, one JSON line): real-time factor of
synthesis, audio seconds synthesized per wall-clock second across all
concurrent streams, `synthesis_rt_factor_per_chip` (the JAX package's
name; here the chip is one card). BASELINE.md's target is >= 300x.

Per-stage lines print first (LPCNET_BENCH_STAGES=none skips them):
features, encode, decode, plc_step, dred_encode, dred_decode, train_step
and the B=1 / B=8 frame latencies; then the on-device verify line (on the
card by default, LPCNET_BENCH_VERIFY=0 skips it), then the headline's
model_flops_estimate and the trace-measured sample_kernel_duty_cycle and
kernel_arithmetic_tflops. These count the CUDA kernels' own operations
against the card's peak: float32 outside the tensor cores, the rate the
sample kernels run at (--fmad=false).

Env overrides of the headline, as in bench.py: LPCNET_BENCH_BATCH
(streams, 1024), LPCNET_BENCH_FRAMES (per call, 50), LPCNET_BENCH_ITERS
(5), LPCNET_BENCH_DEVICES=all (one rank per visible card through
parallel/mesh.spawn and shard_synthesis, the same streams per card; prints
synthesis_rt_factor_total with devices and per_device),
LPCNET_BENCH_REAL_FEATURES=1 (the golden speech's features tiled over the
streams instead of random ones), LPCNET_PROFILE_DIR (where the trace of
the timed loop goes; on the card a temporary directory otherwise).
bench.py's LPCNET_BENCH_BACKEND has no counterpart: on the card the
hand-written kernel is the only path (the plain loop takes seconds per
frame there), and --device cpu runs the plain loops.

Random-init weights come from the port's init_params with seeded torch
generators, so they are not the JAX package's bits; inputs come from the
same numpy seeds as bench.py's. The synthesis stages use the port's
Synthesizer default, the shipped vocoder weights.
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .constants import FRAME_SIZE, NB_BANDS, NB_TOTAL_FEATURES
from .device import resolve_device
from .utils import graphs

GOLDEN_SPEECH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             os.pardir, "tests", "golden", "speech.s16")
# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet, at
# the full 700 W power limit)
PEAK_F32_FLOPS = 67e12
# FLOPs per sample and stream: the model's, as the C engine performs them
# (GRU-A recurrent 384x1152 dominates, nnet.c:410-448); the CUDA sample
# kernels' own (GRU-A and GRU-B recurrent, wi_b, dual-FC: the one-hot
# embedding products are row reads there and the flat sampler a scan, so
# the same count as the model's and as chip_smoke.py's bound); and
# bench.py's dense-equivalent count of the TPU kernel (those embedding
# products 3x256x1152 and a flat scorer 256x256 at full density)
CFG_FLOPS = 2 * (384 * 1152 + 384 * 48 + 16 * 48 + 2 * 16 * 256)
KERNEL_FLOPS = CFG_FLOPS
DENSE_KERNEL_FLOPS = 2 * (3 * 256 * 1152 + 384 * 1152 + 384 * 48 + 16 * 48
                          + 16 * 512 + 256 * 256)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warmup_calls(device: torch.device) -> int:
    """Calls before the clock starts: on the card graphs.CAPTURE_CALL, so
    that a graphed entry point's eager call and capture are paid before
    it (as bench.py's warm-up pays jax.jit's compile), one on the CPU."""
    return graphs.CAPTURE_CALL if device.type == "cuda" else 1


def _timeit(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of fn after _warmup_calls warm-up calls, the card
    synchronised before the clock starts and after the last call."""
    for _ in range(_warmup_calls(device)):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _gen(seed: int, device=None) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _speech_features(batch: int, frames: int, device) -> torch.Tensor:
    """Real-speech features tiled to the bench batch."""
    from . import features as F
    pcm = np.fromfile(GOLDEN_SPEECH, np.int16).astype(np.float32)
    # superframe mode needs whole superframes (T % 4 == 0)
    T = min(frames, len(pcm) // FRAME_SIZE) // 4 * 4
    x = torch.as_tensor(pcm[None, :T * FRAME_SIZE], device=device)
    _, feats, _ = F.compute_features(F.init_state(1, device), x)
    reps = (frames + T - 1) // T
    return feats.repeat(batch, reps, 1)[:, :frames]


def _random_features(batch: int, frames: int, device=None) -> torch.Tensor:
    rs = np.random.RandomState(0)
    feats = np.zeros((batch, frames, NB_TOTAL_FEATURES), np.float32)
    feats[..., :18] = rs.randn(batch, frames, 18) * 0.3
    feats[..., 18] = rs.uniform(-1, 1, (batch, frames))
    feats[..., 19] = rs.uniform(0, 1, (batch, frames))
    return torch.as_tensor(feats, device=device)


def _rt(result_name: str, audio_seconds: float, dt: float, extra=None):
    rt = audio_seconds / dt
    d = {"metric": result_name, "value": round(rt, 2), "unit": "x_realtime",
         "vs_baseline": round(rt, 2)}
    if extra:
        d.update(extra)
    return d


def _pcm(rs: np.random.RandomState, batch: int, n: int, device):
    return torch.as_tensor(rs.randn(batch, n).astype(np.float32) * 3000,
                           device=device)


# --------------------------------------------------------------- stages

@torch.no_grad()
def bench_features(batch=128, frames=64, iters=5, device=None):
    """The feature step (data.feature_step, bench.py:93's jitted
    compute_features): its warm-up calls capture it, the timed calls
    replay it."""
    from . import features as F
    from .data import feature_step
    dev = resolve_device(device)
    pcm = _pcm(np.random.RandomState(1), batch, frames * FRAME_SIZE, dev)
    state = F.init_state(batch, dev)
    step = feature_step(False)
    dt = _timeit(lambda: step(state, pcm), iters, dev)
    return _rt("features_rt_factor", batch * frames * FRAME_SIZE / 16000.0,
               dt, {"batch": batch})


@torch.no_grad()
def bench_codec(batch=128, n_sf=16, iters=5, device=None):
    """The encode and decode steps (data.codec_step, bench.py:122-125's
    jitted encode_superframes and decode_packets), each captured in its
    warm-up calls and replayed in the timed ones; the input features are
    one eager call, as bench.py's one call of its jitted feature step."""
    from . import features as F
    from .cli import load_codebooks
    from .data import codec_step
    dev = resolve_device(device)
    cbs = load_codebooks(None, dev)     # shipped, else random placeholders
    pcm = _pcm(np.random.RandomState(2), batch, n_sf * 4 * FRAME_SIZE, dev)
    _, feats, sps = F.compute_features(F.init_state(batch, dev), pcm,
                                       quantize_pitch=True)
    vq_mem = torch.zeros((batch, NB_BANDS), device=dev)
    enc = codec_step("encode_superframes", cbs)
    dec = codec_step("decode_packets", cbs)
    dt_enc = _timeit(lambda: enc(feats, vq_mem, sps), iters, dev)
    bufs = enc(feats, vq_mem, sps)[0]
    dt_dec = _timeit(lambda: dec(bufs, torch.zeros_like(vq_mem)), iters,
                     dev)
    audio = batch * n_sf * 4 * FRAME_SIZE / 16000.0
    return [_rt("encode_rt_factor", audio, dt_enc, {"batch": batch}),
            _rt("decode_feat_rt_factor", audio, dt_dec, {"batch": batch})]


@torch.no_grad()
def bench_plc(batch=1024, frames=8, iters=3, device=None):
    from .models import lpcnet, plc as pm
    from .plc import PLCEngine
    dev = resolve_device(device)
    cfg = lpcnet.LPCNetConfig()
    eng = PLCEngine(lpcnet.init_params(_gen(0), cfg),
                    pm.init_params(_gen(1)), cfg, device=dev)
    state = eng.init_state(batch)
    rs = np.random.RandomState(3)
    pcm = _pcm(rs, batch, frames * FRAME_SIZE, dev)
    lost = torch.as_tensor(rs.uniform(size=(batch, frames)) < 0.2,
                           device=dev)
    dt = _timeit(lambda: eng.run(state, pcm, lost), iters, dev)
    return _rt("plc_step_rt_factor", batch * frames * FRAME_SIZE / 16000.0,
               dt, {"batch": batch})


@torch.no_grad()
def bench_dred(batch=64, frames=64, iters=5, device=None):
    from .dred import DREDCodec
    from .models import rdovae as rv
    dev = resolve_device(device)
    dc = DREDCodec(rv.init_params(_gen(2), rv.RDOVAEConfig()), device=dev)
    rs = np.random.RandomState(4)
    feats = torch.as_tensor(rs.randn(batch, frames, 20).astype(np.float32)
                            * .3, device=dev)
    dt_enc = _timeit(lambda: dc.encode(feats), iters, dev)
    zd, sd = dc.encode(feats)
    sym, qid = dc.quantize_payload(zd)
    dt_dec = _timeit(lambda: dc.decode(sym, qid, sd[:, 0]), iters, dev)
    audio = batch * frames * FRAME_SIZE / 16000.0
    return [_rt("dred_encode_rt_factor", audio, dt_enc, {"batch": batch}),
            _rt("dred_decode_rt_factor", audio, dt_dec, {"batch": batch})]


def bench_train(batch=64, iters=5, device=None):
    from . import convert
    from .models import lpcnet
    from .training import lpcnet_task
    dev = resolve_device(device)
    cfg = lpcnet.LPCNetConfig()
    params = convert.to_device(lpcnet.init_params(_gen(0), cfg), dev)
    opt = lpcnet_task.make_optimizer()
    opt_state = opt.init(params)
    rs = np.random.RandomState(5)
    T = 15

    def f32(x):
        return torch.as_tensor(x.astype(np.float32), device=dev)

    batch_d = {
        "sig_in": f32(rs.randn(batch, T * FRAME_SIZE) * 3000),
        "sig_out": f32(rs.randn(batch, T * FRAME_SIZE) * 3000),
        "features": f32(rs.randn(batch, T + 4, 20) * .3),
        "periods": torch.as_tensor(rs.randint(33, 255, (batch, T + 4)),
                                   dtype=torch.int32, device=dev),
        "lpc": f32(rs.randn(batch, T, 16) * .1),
    }
    noise = _gen(9, dev)

    def run():
        return lpcnet_task.train_step(params, opt_state, batch_d, cfg, opt,
                                      noise)[2]["loss"]

    dt = _timeit(run, iters, dev)
    samples_s = batch * T * FRAME_SIZE / dt
    return {"metric": "train_step_samples_per_s",
            "value": round(samples_s, 0), "unit": "samples/s",
            "vs_baseline": round(1.0 / dt, 3), "batch": batch,
            "steps_per_s": round(1.0 / dt, 3)}


def _timed_synthesis(synth_fn, state, feats, iters: int,
                     device: torch.device, profile_dir: Optional[str]
                     ) -> float:
    """_warmup_calls warm-up calls, then `iters` calls of synth_fn traced
    into profile_dir (on the card its activity alone; nothing when
    profile_dir is None). Returns their wall seconds, the card
    synchronised at both ends."""
    from .utils import profiling
    for _ in range(_warmup_calls(device)):
        state, _ = synth_fn(state, feats)
    _sync(device)
    with profiling.trace(profile_dir, cpu=device.type != "cuda"):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = synth_fn(state, feats)
        _sync(device)
        return time.perf_counter() - t0


def _features(batch: int, frames: int, real: bool, device):
    return (_speech_features(batch, frames, device) if real
            else _random_features(batch, frames, device))


def synthesis_rank(rank: int, world: int, device, batch: int, frames: int,
                   iters: int, real: bool, profile_dir: str) -> float:
    """One rank of LPCNET_BENCH_DEVICES=all (parallel/mesh.spawn): this
    rank's block of the `batch` streams through shard_synthesis, warmed
    up, then timed after a barrier; rank 0 traces into profile_dir
    (empty: none). Returns the rank's wall seconds."""
    import torch.distributed as dist

    from .models import lpcnet
    from .parallel import mesh
    from .vocoder import Synthesizer
    voc = Synthesizer(lpcnet.LPCNetConfig(), device=device)
    state, synth_fn = mesh.shard_synthesis(voc, batch)
    feats = _features(batch, frames, real, device)
    state, _ = synth_fn(state, feats)            # this rank's set-up
    _sync(device)
    dist.barrier()
    return _timed_synthesis(synth_fn, state, feats, iters, device,
                            profile_dir if rank == 0 and profile_dir
                            else None)


@torch.no_grad()
def bench_synthesis(device=None):
    """The headline: Synthesizer(LPCNetConfig()).synthesize at
    LPCNET_BENCH_BATCH streams x LPCNET_BENCH_FRAMES frames per call,
    LPCNET_BENCH_ITERS timed calls after the warm-up ones (on the card,
    the flat frame kernel K1 once per frame, replayed as a CUDA graph). Returns (result line, RT factor,
    the trace's utilization or None)."""
    from .models import lpcnet
    from .utils import profiling
    from .vocoder import Synthesizer

    dev = resolve_device(device)
    batch = int(os.environ.get("LPCNET_BENCH_BATCH", "1024"))
    frames = int(os.environ.get("LPCNET_BENCH_FRAMES", "50"))
    iters = int(os.environ.get("LPCNET_BENCH_ITERS", "5"))
    multi = os.environ.get("LPCNET_BENCH_DEVICES", "") == "all"
    profile_dir = os.environ.get("LPCNET_PROFILE_DIR")
    real_feats = os.environ.get("LPCNET_BENCH_REAL_FEATURES", "") == "1"

    with tempfile.TemporaryDirectory(prefix="lpcnet_bench_trace_") as tmp:
        if not profile_dir and dev.type == "cuda" and not multi:
            # always trace the timed loop on the card, so that the
            # utilization lines are measured from THIS run's trace
            profile_dir = tmp
        if multi:
            from .parallel import mesh
            if dev.type != "cuda":
                raise ValueError("LPCNET_BENCH_DEVICES=all runs one rank "
                                 "per card; there is no card here")
            n_dev = torch.cuda.device_count()
            batch = batch * n_dev        # weak scaling: same load per card
            dts = mesh.spawn("lpcnet_tpu_torch.bench:synthesis_rank", n_dev,
                             args=(batch, frames, iters, real_feats,
                                   profile_dir or ""))
            dt = max(dts)
        else:
            voc = Synthesizer(lpcnet.LPCNetConfig(), device=dev)
            state = voc.reset(batch, per_stream_rng=True)
            dt = _timed_synthesis(voc.synthesize, state,
                                  _features(batch, frames, real_feats, dev),
                                  iters, dev, profile_dir)
        util = (profiling.parse_trace_utilization(profile_dir)
                if profile_dir else None)

    audio_seconds = iters * batch * frames * FRAME_SIZE / 16000.0
    rt_factor = audio_seconds / dt
    result = {
        "metric": "synthesis_rt_factor_per_chip",
        "value": round(rt_factor, 2),
        "unit": "x_realtime",
        "vs_baseline": round(rt_factor / 1.0, 2),
    }
    if real_feats:
        result["features"] = "speech"
    if multi:
        per_device = rt_factor / n_dev
        # the >=300x target is per card: compare per-device, not aggregate
        result.update(metric="synthesis_rt_factor_total", devices=n_dev,
                      per_device=round(per_device, 2),
                      vs_baseline=round(per_device, 2))
    return result, rt_factor, util


def model_flops_estimate(rt_factor: float, peak: float = PEAK_F32_FLOPS):
    """DERIVED sanity line (back-computed from the RT factor, not a
    measurement): the model FLOPs the C engine performs per sample,
    delivered per second across all streams, as a share of `peak` (the
    card's float32 peak). The CUDA kernels do the same operations, so this
    is their arithmetic over the whole wall time; the measured
    counterparts are sample_kernel_duty_cycle and
    kernel_arithmetic_tflops (over the kernels' busy time)."""
    model_flops = CFG_FLOPS * rt_factor * 16000.0
    return {"metric": "model_flops_estimate", "value":
            round(model_flops / 1e12, 3), "unit": "model_tflops_derived",
            "vs_baseline": round(100.0 * model_flops / peak, 3),
            "percent_fp32_peak": round(100.0 * model_flops / peak, 3)}


def kernel_utilization_lines(rt_factor: float, util,
                             peak: float = PEAK_F32_FLOPS) -> List[Dict]:
    """TRACE-MEASURED utilization of the sample kernels: duty cycle = the
    share of the traced window the sample kernels ran (with the window's
    device occupancy beside it), and achieved arithmetic = the CUDA
    kernels' COUNTED per-sample operations (KERNEL_FLOPS) divided by the
    trace-measured kernel-busy time, as a share of `peak`; bench.py's
    dense-equivalent count (DENSE_KERNEL_FLOPS) over the same time beside
    it, unrelated to the peak."""
    if not util:
        return []
    lines = [{"metric": "sample_kernel_duty_cycle",
              "value": round(100.0 * util["duty_cycle"], 2),
              "unit": "percent_wall_measured",
              "vs_baseline": round(100.0 * util["duty_cycle"], 2),
              "busy_us_by_class": util["busy_us_by_class"],
              "device_occupancy": util["device_occupancy"]}]
    busy = max(util["duty_cycle"], 1e-6)
    achieved = KERNEL_FLOPS * rt_factor * 16000.0 / busy
    dense = DENSE_KERNEL_FLOPS * rt_factor * 16000.0 / busy
    lines.append({"metric": "kernel_arithmetic_tflops",
                  "value": round(achieved / 1e12, 2),
                  "unit": "tflops_counted_over_measured_busy",
                  "vs_baseline": round(100.0 * achieved / peak, 2),
                  "percent_fp32_peak": round(100.0 * achieved / peak, 2),
                  "dense_equivalent_tflops": round(dense / 1e12, 2),
                  "note": "the CUDA kernels' own operations; the dense-"
                          "equivalent count adds the one-hot embedding "
                          "products and the flat scorer at full density"})
    return lines


def latency_metric(batch: int, device: torch.device) -> str:
    """bench.py's name with the path: 'cuda' for the card's kernel (where
    bench.py has 'pallas'), 'scan' for the plain loop, as bench.py names
    its portable path."""
    return (f"frame_latency_b{batch}_"
            f"{'cuda' if device.type == 'cuda' else 'scan'}_ms")


@torch.no_grad()
def bench_latency(iters=200, device=None):
    """Per-frame synthesis latency of one 160-sample frame per call (the
    streaming contract, lpcnet_synthesize include/lpcnet.h:188) at B=1 and
    B=8, against the reference's operating point: ONE stream inside the
    10-ms frame budget. vs_baseline = 10 ms / latency. On the card this
    is the kernel path alone (plan L): the plain loop takes seconds per
    frame there."""
    from .models import lpcnet
    from .vocoder import Synthesizer
    dev = resolve_device(device)
    out = []
    rs = np.random.RandomState(7)
    voc = Synthesizer(lpcnet.LPCNetConfig(), device=dev)
    for batch in (1, 8):
        feats = np.zeros((batch, 1, NB_TOTAL_FEATURES), np.float32)
        feats[..., :18] = rs.randn(batch, 1, 18) * 0.3
        feats[..., 18] = 0.2
        feats[..., 19] = 0.5
        feats = torch.as_tensor(feats, device=dev)
        state = voc.reset(batch, per_stream_rng=True)
        for _ in range(_warmup_calls(dev)):
            state, _ = voc.synthesize(state, feats)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = voc.synthesize(state, feats)
        _sync(dev)
        ms = (time.perf_counter() - t0) / iters * 1000.0
        out.append({
            "metric": latency_metric(batch, dev),
            "value": round(ms, 3), "unit": "ms_per_10ms_frame",
            "vs_baseline": round(10.0 / ms, 2), "batch": batch,
            "real_time": bool(ms < 10.0)})
    return out


def bench_verify(report: Optional[Dict[str, Any]] = None, device=None):
    """The on-device verification of the built kernels against their plain
    versions (verify.py) as one line; raises on any gate failure. report:
    a verify_on_device report already made, else it runs here."""
    from . import verify
    if report is None:
        report = verify.verify_on_device(device=device)
    return verify.summary_line(report)


def main(argv=None, iters: Optional[int] = None,
         report: Optional[Dict[str, Any]] = None,
         on_stage=None) -> List[Dict[str, Any]]:
    """Print the bench's lines, the headline last, and return them.
    iters: the timed calls of the throughput stages, features to train
    (None: each stage's default; the latency stage keeps its 200 one-frame
    calls, the headline LPCNET_BENCH_ITERS); report: a verify_on_device
    report for the verify line instead of running it again; on_stage: a
    function of a stage's name ("bench_features" ... "bench_latency",
    "bench_verify", "bench_synthesis") whose context manager each stage
    runs inside."""
    ap = argparse.ArgumentParser(prog="python -m lpcnet_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--verify", action="store_true",
                    help="print the on-device verify line only")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain loops)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    stage = on_stage or (lambda name: contextlib.nullcontext())
    lines: List[Dict[str, Any]] = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    def run(name, fn, **kw):
        with stage(name):
            out = fn(device=dev, **kw)
        for line in out if isinstance(out, list) else [out]:
            emit(line)

    if args.verify:
        run("bench_verify", bench_verify, report=report)
        return lines
    # the per-stage lines print by default; the headline stays LAST
    stages = os.environ.get("LPCNET_BENCH_STAGES", "all") != "none"
    if stages:
        it = {} if iters is None else {"iters": iters}
        for name, fn, kw in (("bench_features", bench_features, it),
                             ("bench_codec", bench_codec, it),
                             ("bench_plc", bench_plc, it),
                             ("bench_dred", bench_dred, it),
                             ("bench_train", bench_train, it),
                             ("bench_latency", bench_latency, {})):
            run(name, fn, **kw)
    # every recorded run on the card is also a correctness proof of the
    # kernels it timed (LPCNET_BENCH_VERIFY=0 skips it)
    if (os.environ.get("LPCNET_BENCH_VERIFY", "1") != "0"
            and dev.type == "cuda"):
        run("bench_verify", bench_verify, report=report)
    with stage("bench_synthesis"):
        result, rt, util = bench_synthesis(dev)
    if stages:
        emit(model_flops_estimate(rt))
        for line in kernel_utilization_lines(rt, util):
            emit(line)
    emit(result)
    return lines


if __name__ == "__main__":
    main()
