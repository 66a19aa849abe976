#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lpcnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - nvcc builds every CUDA source (lpcnet_tpu_torch/csrc) into
               build/lpcnet_tpu_torch/, one process per source, together.
  1b. plans  - the card's count of co-resident 16-CTA clusters
               (cudaOccupancyMaxActiveClusters) and the plan boundary
               B = 8 x that count: plan L below, plan T above.
  2. synthesis - the user's entry point, Synthesizer(...).synthesize, on the
               golden reference features tiled over the streams, per-stream
               RNG, shipped weights, with each of the four frame variants:
               B=1024 x 50 frames with the default flat sampler and with the
               fused kernel with thresholds drawn ahead (opt), x 4 with the
               walked sampler (base) and the fused kernel (fuse); then
               the same at B=1, and flat at the plan boundary x 10
               frames. The launch counts are set to 0 just before
               each run and read just after it, the counts by plan too:
               every launch (K1/K2 and K5 alike) took its batch's plan (L
               at B=1 and the boundary, T at B=1024) or the run fails.
               Each run is then held
               against its plain PyTorch version (kernels/sample_scan.py)
               on the card, on the run's own state and the first frame
               of its own conditions, with the gates of
               lpcnet_tpu/verify.py: rng exact, pcm exact fraction >= 0.95,
               correlation >= 0.999; the run's pcm must be the kernel's on
               those inputs, flat and base the same bits (pcm, exc, rng),
               and fuse and opt the bits of the base kernel on the same
               inputs (pcm, exc, rng and the GRU states). Kernel times by
               CUDA events.
  2b. bf16  - Synthesizer(variant=..., tables="bf16").synthesize, each of
               the four frame variants, B=1024 x 1 frame of the golden
               features (plan T; launches counted under <variant>_bf16
               alone), then the bf16 instance of K1, K2 and K5 under plan L
               at B=1 and the boundary and plan T at B=1024 on the run's
               first streams: pcm, exc, rng and both GRU states equal to
               the plain loop's on the same bf16 tables and to the float32
               instance's on the tables widened, exactly; each bf16
               instance timed beside its float32 one (CUDA events).
  2c. codec  - the 1.6 kb/s codec end to end through the steps of the
               `encode` and `decode` commands: tests/golden/speech.s16
               (50 packets) at B=1 and, each stream rotated by 37 samples
               more, at B=1024: superframe features with quantized pitch
               and encode_superframes per 64-frame chunk, decode_packets,
               then Synthesizer.synthesize over the decoded features in
               64-frame calls with tables="f32" and with tables="bf16":
               one K1 launch per frame, of the flat_bf16 instance in the
               bf16 runs, and nothing else. The card's packets are held
               against the port's own encode on the CPU (B=1 and four of
               the 1024 streams) with the JAX-vs-C codec gates: whole
               packets >= 0.90, bytes >= 0.95; the decoded features
               against the CPU decode to 1e-5; each synthesis run against
               the plain loop as in phase 2. [codec] lines: encode ms per
               packet, decode ms, synthesis ms per frame (host clock,
               synchronised).
  2d. dred  - DRED end to end with the shipped cond-256/256 weights (80
               latents, 16-dframe payloads), as the fec-encode command runs
               it: the golden speech at B=1 and B=1024 (rotated as in 2c),
               superframe features, DREDCodec.encode, then quantize_payload
               and decode at every packet position. Held against the port
               on the CPU (B=1 and the first 2 streams of B=1024, on the
               card's features): symbols >= 99.5% equal and within 1, PVQ
               states equal on >= 99% of the dframes, features decoded
               from the same symbols and states within 1e-3; the q0 round
               trip of 160 frames (tests/test_rdovae.py's recipe) RMS < 0.8
               and within 2% of the CPU's. [dred] lines: encode ms for the
               file, quantize + decode ms per payload.
  3. plc     - PLCEngine(...).run with the shipped vocoder and PLC weights
               on the golden speech tiled over the streams, per-stream loss
               flags (20%, runs of 1-3 frames): B=1024 x 50 frames and B=1
               x 50 (flat sampler), B=1024 x 10 (base). Exactly one
               synth_samples launch and one Burg kernel launch
               (csrc/burg_cepstrum.cu) per 10-ms step and no other sample
               kernel; output finite, int16 range, good rows equal to their
               input.
  3b. burg   - Burg's cepstral analysis (ops/burg.py) at B=1 and B=1024
               frames of the golden speech: the kernel
               (csrc/burg_cepstrum.cu, one launch a call) against the plain
               PyTorch version on the card, max |d| <= BURG_TOL; then the
               device time of each per call, both replayed from CUDA graphs
               (BURG_REPS kernel launches in one graph, one plain call of
               ~1700 kernels in another), as the PLC step's graph runs them.
  3c. lpc    - LPC from the cepstrum (ops/dsp.lpc_from_cepstrum) on 1 x 1
               and 1024 x 50 rows of the golden features: the card's path
               (PyTorch operations up to the inverse FFT, then one launch of
               csrc/lpc_levinson.cu) against the plain PyTorch version on
               the card, bit for bit; then the device time per call of the
               kernel alone (LPC_REPS launches in one graph), of the card's
               path and of the plain version (~427 kernels), each replayed
               from a CUDA graph.
  4. noncausal - NonCausalPLCEngine(...).run, B=1024 x 10 frames (plan
               T) and B=1 x 3 (plan L): 4 synth_samples and 3
               teacher_advance launches per step, each teacher_advance call
               one launch; one Burg kernel launch per step.
  4b. modes  - Synthesizer.synthesize_streaming, B=1024 x 10 frames (one
               free-run synth_samples launch per frame; the first
               `lookahead` frames are silence and leave the sample state
               and the RNG a fresh reset's), and synthesize_teacher, B=1024
               x 4 frames with per-stream preload counts (one launch per
               frame; forced samples equal the target).
  4c. strict - StrictCausalPLCEngine(...).run on the same speech and loss
               flags, B=1024 x 10 frames and B=1 x 10 (the single stream
               is made to lose frames 3 and 4): exactly 8
               synth_samples launches per step (each with per-stream active
               counts), one Burg kernel launch and no teacher_advance;
               output finite, int16 range,
               good rows equal to their input, blend rows in their second
               half.
  4d. dred-plc - PLCEngine.step at B=1024 and B=1 over the speech of 2d
               with loss_flags (200 frames): before each step, every lost
               stream queues (fec_add) the features of that frame from the
               newest DRED payload that covers it. One K3 launch per step
               (held in phase 5); gates: some lost frames were concealed
               from DRED features, good rows equal their input.
  4e. dotprod - Synthesizer(backend="dotprod"), signed and SU flavours, B=4
               x 2 frames, on the card and on the CPU: no hand-written
               kernel launched; on the CPU run's tables and conditions the
               card gives its pcm, exc, rng and GRU states exactly; the
               card's own run has the CPU run's rng.
  4f. tools  - rdovae-encode, rdovae-decode, fec-encode, plc-test and
               addlpc through cli.main in a temporary directory, on the card
               and with --device cpu, held to the tolerances of
               tests/test_torch_tools.py; dump-weights-blob read back.
  4g. train  - training end to end: dump-data train on the golden speech
               (24 augmentation passes batched, ~4800 frames) on the card
               and with --device cpu (features within 1e-4, sig_out exact,
               sig_in equal >= 0.95, RMS of the difference <= 1% of the
               signal's) and dump-data btrain (16 passes);
               train-lpcnet at LPCNetConfig(): one noise-free step on the
               card against the host CPU at B=4 x 2400 (loss relative
               1e-5, gradients within 1e-4 of each leaf's largest entry,
               TF32 refused). Each trainer's train_step as a user runs
               it, a CUDA graph from its second step (LPCNet 32 x 2400 x
               6 steps with the loss falling, PLC PLCConfig() seq 200 x 8,
               RDO-VAE cond 1024/256 seq 400 x 8), against 3 eager steps
               from the same seeds: the graphed steps bit-identical
               (params, Adam state, metrics, the generator's state);
               eager and replayed ms per step, samples (frames) per s,
               the capture's s and the graph's nodes, peak memory. Then
               train-lpcnet for 2 epochs of 3 steps (one capture, 5
               replays) and its --resume (parameters restored bit for
               bit, step and Adam counts continued), train-plc,
               train-rdovae and vq-train at the shipped sizes
               (--iters 1 --final-iters 2) through their commands.
               [train] lines also: s per dump-data pass, vq-train s,
               whether the native library loaded or was built. No sample
               kernel launches in this phase.
  4h. dp    - multi-GPU over torch.distributed (parallel/mesh.py), each
               rank a process of its own (mesh.spawn): an NCCL world over
               every visible card and a gloo world of two ranks on cuda:0
               (NCCL takes one rank per card). In each, shard_synthesis of
               B=1024 x 4 frames of the tiled golden features (per-stream
               seeds, rank r's block of 1024/world streams): every rank
               launches K1 once per frame under its batch's plan (counts
               set to 0 in the rank just before its timed run and read just
               after it) and holds its launch against the plain loop on its
               own state and conditions; rank 0's gathered pcm bit-identical
               to one Synthesizer at B=1024 here. Then dryrun_training_step
               (LPCNetConfig(), B = 2 x world, T=3): the ranks' parameters
               equal exactly, the loss within 1e-5 (relative) of the
               single-process step on the whole batch here. In the NCCL
               world each rank then runs that step DP_GRAPH_STEPS times
               under graphs.disabled() and graphed (mesh.dp_train_step:
               the first step eager, the second captured with both
               all-reduces inside, the others replays), parameters, Adam
               state, metrics and the noise generator bit-identical, one
               capture. [dp] lines: ms per frame per rank, the gather, the
               plan, ms per step, eager and replayed ms per DP step and
               the capture's s.
  4i. profile - the first traces of the device's idle share:
               utils/profiling.parse_trace_utilization over one traced
               Synthesizer.synthesize frame at B=1024 and B=1 and one
               PLCEngine.step at B=1, each traced with host operators and
               with the device alone, beside the call untraced. Fails
               unless every trace holds sample-kernel events and its device
               occupancy lies in (0, 1]; a trace without them is taken
               again, TRACE_TRIES takes at most (trace_call). [profile]
               lines: occupancy, the sample kernels' duty cycle, the top
               kernels by busy us. The traced frames' K1 launches are held
               against the plain loop, the PLC step's K3 launch in phase 5.
  4j. verify, bench, eval - lpcnet_tpu_torch.verify.verify_on_device():
               every kernel against its oracle at B=1024 with the JAX
               package's gate names and thresholds, the fused variants
               against base, and a 3-frame strict run through the kernels
               against the same engine through the plain loops. Then
               lpcnet_tpu_torch.bench.main on that report (verify does not
               run again) at bench.py's default sizes, BENCH_ITERS timed
               calls per throughput stage, through the graphed entry
               points (each stage's two warm-up calls run the first call
               of its shape eagerly and capture the second, its timed
               calls replay): its lines in bench.py's order
               (the latency lines named _cuda_ms), verify at 1.0, the
               headline last. Through main's on_stage the counts are set
               to 0 just before and read just after each stage, launches
               from the host in the eager calls and captures alone: the
               headline (K1 under plan T, 1024 streams x 50 frames, 1
               capture and 6 replays), the latency stage (K1 under plan L
               at B=1 and B=8, a capture and 201 replays each) and the PLC
               stage (K3 under plan T, 1024 x 8 frames); the train stage
               captures its step once and replays it; no other stage
               launches a sample kernel; DRED's stage captures encode
               and decode, the features stage data.feature_step, the
               codec stage data.encode_superframes and decode_packets.
               The launches the card ran (the eager calls'
               and the replays') are counted beside those from the host.
               The headline's first frame and the latency stage's eager
               call at B=1 and at B=8, and the last replay of each of
               those graphs (its inputs and outputs read from the graph's
               tensors), are held against the plain loop with the gates
               of phase 2; each replay is bit-identical to an eager
               kernel call on its inputs. The headline's window is timed
               again untraced. Then the
               evaluations and fits of lpcnet_tpu_torch/tools/ with the
               shipped artifacts: eval_lpcnet on the golden speech (K1
               under plan L, one launch per frame; within EVAL_JAX_TOL of
               the JAX tool's numbers on the CPU and well above random
               init), eval_plc on a btest file that dump-data makes on the
               card, eval_dred at 16 levels, train_codebooks into build/,
               fit_pade; each held against the port's CPU run of the same
               function on a short window (EVAL_FRAMES frames, EVAL_LEVELS,
               the shipped codebooks, a 20-step fit) with the tolerances
               of tests/test_torch_eval_tools.py. [bench], [eval] lines.
  4k. graft - lpcnet_tpu_torch/graft_entry.py, the port of
               __graft_entry__.py: entry() at B=32 (its default) and B=1,
               each x one frame. Counts set to 0 just before and read just
               after two eager calls of its fn (the example args, then the
               state they left and a second frame of golden features at
               offsets from RandomState(B)): K1 once per call under plan
               L. Each call held against the plain loop on the same state
               and conditions (phase 2's gates; max |d| printed); then
               compile_step captures fn as one CUDA graph, and its replay
               on each argument set is bit-identical to the eager call
               (pcm and every state leaf). Eager calls and replays timed
               (host clock, synchronised, GRAFT_REPS each; the graph's
               replay alone by CUDA events) and each traced alone with
               utils/profiling.trace(cpu=False), GRAFT_TRACES times
               (trace_call: an eager take must add one launch to the
               counts, and a take without the sample kernel is taken
               again, TRACE_TRIES takes at most): the
               median device occupancy and busy us side by side, and the
               replay's busy us over the graph alone's CUDA-event time.
               Then graft_entry.dryrun_multichip
               over every visible card. [graft] lines.
  4l. graphs - the entry points as CUDA graphs (utils/graphs.jit, the
               counterpart of jax.jit): Synthesizer.synthesize (flat, base,
               fuse, opt, each with f32 and bf16 tables),
               synthesize_teacher, synthesize_streaming, the step of
               PLCEngine, NonCausalPLCEngine and StrictCausalPLCEngine,
               DREDCodec.encode and decode, at B=1 (plan L) and B=1024
               (plan T): 3 calls of 4 frames (4 steps; DRED 3 of 64
               frames) that carry the state; the dotprod synthesize and
               synthesize_streaming (plain loops) at B=1, two calls of 1
               frame. Each chain graphed is bit-identical to the same
               chain under graphs.disabled() (pcm and every state leaf);
               the first call of a shape runs eagerly, the second
               captures; counts set to 0 before the graphed chain: every
               launch is the eager call's or the capture's, under the
               batch's plan. [graphs] lines: the first call's ms, the
               capturing call's s and the capture alone, eager and
               replayed ms per call (host clock, synchronised, median of
               5), captures and replays, memory before and peak; the PLC
               step at B=1 beside its 10-ms limit.
               synthesize_temperature at B=1 and B=1024, TEMP_CALLS calls
               of 1 frame eager and graphed (its conditioning jit, its
               sample step captured once and replayed 160 times a frame),
               bit-identical; ms per frame eager and graphed, the step's
               capture s. The other jit sites at their callers' sizes
               (jit_site_cases: the feature step of the bench, the encode
               command and dump-data test, the four codec steps, the
               Lloyd pass and kmeans_multi's update at the
               codebooks' sizes, fit_pade's step, train_codebooks'
               feats_of, eval_plc's forward), JIT_SITE_CALLS calls eager
               and graphed, bit-identical (the k-means generator too);
               eager and replayed ms per call and the capture s. One-shot
               callers (a CLI chunk of 64 frames, eval_lpcnet's 200): a
               fresh synthesizer's first three calls of one shape beside
               one eager call. One frame per call at B=1 and B=8, eager
               and replayed (median of 20).
  5. holds   - for every distinct (kernel, argument set, nsamples, batch)
               that phases 3 to 4d, 4i and the bench of 4j launched, the
               arguments of its last launch in the run go through the
               kernel and through its
               plain version on the card: the gates of phase 2 for
               synth_samples; for teacher_advance every state field
               exact, against its plain version and against a fully
               forced synth_samples launch.
  6. times   - CUDA-event time per launch of synth_samples (the PLCEngine
               argument set, 160 samples) and of teacher_advance at B=1024
               and B=1, with the whole teacher_advance call by the host
               clock beside it; K1 (flat), K5 (fuse, opt), K3 and K4 under
               each plan that can take the batch at B=1, the boundary and
               B=1024 (the plan forced through the cluster count
               launch_plan reads; one time per kernel, plan and batch); the
               [phases] split of the step (clock stamps on the first CTA)
               of the frame kernel under plan L at B=1 and the boundary
               and plan T at B=1024 and B=1, and of K4 under plan L at B=1
               and plan T at B=1024, beside the CUDA-event time of the
               same kernel on the same inputs; the PLCEngine step's parts
               one by one and the strict step's split (its 10
               frame_net_step calls, its 8 launches, the rest; host
               clock).
In phases 2 to 4d every run launches the LPC kernel as often as its
entry point calls lpc_from_cepstrum (once a synthesize, synthesize_teacher
or codec synthesis call and once a streaming frame, twice a codec chunk
encoded, twice a PLCEngine step, 8 times a NonCausalPLCEngine step, 11
times a StrictCausalPLCEngine step; LpcTap keeps each call's cepstra),
and every call's lpc and err are the plain version's on the run's own
cepstra, bit for bit ([lpc] lines).
Every phase but 4j's bench and 4l calls the entry points eagerly, inside
graphs.disabled() (the counterpart of jax.disable_jit()): those phases
count launches per call, record their arguments or time eager launches,
and a graph launches its kernels from the host in its capture, never in
a replay. A [clock] line says when each phase starts. It prints one JSON line of
per-kernel numbers, the card's name and power limit, and last
{"ok": true, "device": {...}}. Without a CUDA device, or
without the lpcnet_tpu_torch package beside it, it exits non-zero before
printing any result.
"""
import contextlib
import functools
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
# the same peak as FP32 lane-instructions per second: under --fmad=false a
# multiply-add is two instructions, the floor of the bit-parity contract
PEAK_LANE_INSTR = PEAK_F32_FLOPS / 2
GATE_EXACT, GATE_CORR = 0.95, 0.999
TOLERANCE = "rng exact, pcm exact fraction >= 0.95, corr >= 0.999"
# (variant, streams, frames) of each synthesis run: the four frame variants
# at the server width and for one stream (flat before the others: they are
# compared with it)
PATHS = (("flat", 1024, 50), ("base", 1024, 4), ("opt", 1024, 50),
         ("fuse", 1024, 4), ("flat", 1, 50), ("base", 1, 4), ("opt", 1, 50),
         ("fuse", 1, 4))
# (variant, streams, frames) of each PLCEngine run
PLC_PATHS = (("flat", 1024, 50), ("flat", 1, 50), ("base", 1024, 10))
NONCAUSAL_PATHS = ((1024, 10), (1, 3))    # (streams, frames)
STRICT_PATHS = ((1024, 10), (1, 10))        # (streams, frames)
STREAMING_PATH = (1024, 10)
TEACHER_PATH = (1024, 4)
VERIFY_STRICT_FRAMES = 3
# the argument sets of the strict engine's 8 launches per step:
# (given, nsamples, launches)
STRICT_LAUNCHES = ((("target", "preload", "n_active"), 160, 4),
                   (("n_active",), 80, 3),
                   (("target", "preload", "n_active"), 80, 1))
CODEC_BATCHES = (1, 1024)   # streams of the codec phase
CODEC_CPU_ROWS = (0, 1, 511, 1023)  # streams the CPU encode repeats
CODEC_GATE_PACKETS, CODEC_GATE_BYTES = 0.90, 0.95
CODEC_ROTATE = 37      # samples each codec stream is rotated by, per stream
# DRED: streams of B=1024 the CPU repeats, and the gates of the card against
# the CPU (a float sum in another order can flip a symbol at a rounding tie)
DRED_BATCHES = (1, 1024)
DRED_CPU_ROWS = 2
DRED_GATE_SYMBOLS, DRED_GATE_STATES, DRED_GATE_FEATS = 0.995, 0.99, 1e-3
DOTPROD_PATH = (4, 2)    # (streams, frames) of the DOT_PROD emulation
# training: augmentation passes of the corpus (~4800 frames) and of the PLC
# corpus, the LPCNet batch and steps, and the PLC and RDO-VAE sequence
# lengths and batches, cut so that the corpus covers them
TRAIN_PASSES, PLC_PASSES = 24, 16
# sig_in feeds the mu-law of its own LPC prediction back (dump_data.c:
# 84-108): an LPC coefficient 1e-5 apart (float sums in another order) can
# flip one excitation step, after which the stream runs apart for a while,
# so the card's sig_in is held to the CPU's by fraction and by RMS
SIG_IN_EQUAL, SIG_IN_RMS = 0.95, 1e-2
TRAIN_BATCH, TRAIN_STEPS = 32, 6
# steps of each trainer's eager run (the first a warm-up, the others
# timed), held bit for bit against the graphed run's first steps; the
# graphed run's steps (the first eager, the second captured, the others
# replays, timed)
TRAIN_HELD = 3
PLC_STEPS, RDOVAE_STEPS = 6, 5
PLC_SEQ, PLC_BATCH = 200, 8
RDOVAE_SEQ, RDOVAE_BATCH = 400, 8
# phase 4h: streams and frames of stream-parallel synthesis, frames of the
# dry-run training step, each spawned world's time limit (s)
DP_BATCH, DP_FRAMES, DP_TRAIN_FRAMES, DP_TIMEOUT = 1024, 4, 3, 300
DP_GRAPH_STEPS = 4     # steps of the NCCL world's graphed and eager runs
PROFILE_BATCHES = (1024, 1)   # phase 4i: streams of the traced frames
# phase 4k: streams of the graft entry's step (its default first), the
# timed eager calls and replays of each, and the traced calls of each whose
# median occupancy is reported
GRAFT_BATCHES, GRAFT_REPS, GRAFT_TRACES = (32, 1), 100, 3
TRACE_TRIES = 3               # phases 4i, 4k: takes of a trace, at most
# phase 4l: streams of the graphed chains; calls per chain and frames per
# call (synthesis), steps (the PLC engines), frames per call (DRED: 16
# dframes, one payload); the timed calls of each; the plain-loop entry
# points' calls of one frame and timed calls at B=1; the PLC step's limit
GRAPH_BATCHES = (1, 1024)
GRAPH_CALLS, GRAPH_FRAMES, GRAPH_STEPS, DRED_GRAPH_FRAMES = 3, 4, 4, 64
GRAPH_REPS = 5       # 10 took the phase past 60 s
GRAPH_PLAIN_CALLS, GRAPH_PLAIN_REPS = 2, 1
# temperature synthesis: calls of one frame per batch; the other jit sites:
# calls per chain, and the corpus rows of the k-means passes
TEMP_CALLS = 2
JIT_SITE_CALLS, VQ_ROWS = 4, 32768
# one-shot callers: a CLI chunk (cli.CHUNK_FRAMES) and eval_lpcnet's call on
# the 200 frames of the golden features
ONE_SHOT_FRAMES = (64, 200)
LATENCY_REPS = 20    # one-frame calls timed eager and replayed, each batch
PLC_STEP_LIMIT_MS = 10.0
# phase 4j: the bench's throughput stages run JAX's default sizes with this
# many timed calls (the latency stage its 200, the headline its 5); the
# evaluations' short window for the CPU run, and the tolerances the CPU
# tests state (tests/test_torch_eval_tools.py) for the card against it
BENCH_ITERS = 1
EVAL_FRAMES = 12
EVAL_LEVELS = (0, 15)
EVAL_TOL = {"autocorr": 1e-5, "logspec": 5e-4, "rms_rel": 1e-5,
            "plc_l1": 1e-5, "dred_rel": 1e-4, "vq_rms": 1e-5,
            "pade_seed": 2.5e-7, "pade_coef_rel": 1e-5, "pade_err_rel": 2e-3}
# the JAX tool's numbers on the CPU (tools/eval_lpcnet.py, scan backend)
# for the shipped vocoder on the golden speech: pitch-lag autocorrelation,
# log-spectral correlation, rms; the card's full-length run is held within
# EVAL_JAX_TOL of them (a free run forks at its first sample rounded the
# other way, so the statistics agree, not the samples)
EVAL_JAX = (0.931, 0.705, 2631.0)
EVAL_JAX_TOL = (0.02, 0.02, 0.05)     # absolute, absolute, relative
PADE_STEPS = 300      # steps per stage of the card's fit
CODEBOOK_ARGS = ["--passes", "16", "--iters", "1", "--final-iters", "2"]
# the metric names of the bench's lines on the card, in its order
BENCH_METRICS = (
    "features_rt_factor", "encode_rt_factor", "decode_feat_rt_factor",
    "plc_step_rt_factor", "dred_encode_rt_factor", "dred_decode_rt_factor",
    "train_step_samples_per_s", "frame_latency_b1_cuda_ms",
    "frame_latency_b8_cuda_ms", "on_device_verify", "model_flops_estimate",
    "sample_kernel_duty_cycle", "kernel_arithmetic_tflops",
    "synthesis_rt_factor_per_chip")
# the bench's defaults: the headline's streams, frames per call and timed
# calls; the PLC stage's frames; the latency stage's batches and calls
HEAD_BATCH, HEAD_FRAMES, HEAD_ITERS = 1024, 50, 5
BENCH_PLC_FRAMES, LATENCY_ITERS = 8, 200
CHUNK_FRAMES = 64      # frames per call of the encode and decode commands
BOUNDARY_FRAMES = 10   # frames of the synthesis run at the plan boundary
GATE_FRAMES = 1     # frames of each synthesis run held against the plain one
TIME_FRAMES = 10    # frames per timed kernel call
NA, NB, NL, FS = 384, 16, 256, 160
SOURCES = ("sample_frame", "sample_frame_opt", "synth_samples",
           "teacher_advance", "burg_cepstrum", "lpc_levinson")
# phase 3b: frames a call, kernel launches in the timed graph, the kernel's
# tolerance against the plain version (tests/test_torch_cuda.py's BURG_TOL)
BURG_BATCHES, BURG_REPS, BURG_TOL = (1, 1024), 100, 1e-4
# multiply-adds per stream and sample: GRU-A recurrent, wi_b, GRU-B
# recurrent; and the dual-FC that only the sample loop has
GRU_MACS = NA * 3 * NA + NA * 3 * NB + NB * 3 * NB
DFC_MACS = 2 * NB * NL
GRU_WEIGHT_FLOATS = (3 * NL * 3 * NA + NA * 3 * NA + 3 * NA + NA * 3 * NB
                     + NB * 3 * NB + 3 * NB)
STATE_FLOATS = NA + NB + 16 + 2 + 8     # rng: 4 int64
TABLE_FLOATS = 3 * NL * 3 * NA          # the three embedding tables


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


def sample_bound_ms(batch: int, ns: int, forced: bool,
                    table_bytes: int = 4) -> tuple:
    """Least time for one launch of the sample loop over ns samples: the
    larger of its float32 operations over the peak rate and the bytes it
    must move (each input once, each output once) over the memory rate.
    table_bytes: bytes per element of the three embedding tables (2 for the
    bf16 instances)."""
    flops = 2.0 * (GRU_MACS + DFC_MACS) * ns * batch
    weights = ((GRU_WEIGHT_FLOATS + 2 * NB * NL + 4 * NL + 2 * NL) * 4
               - TABLE_FLOATS * (4 - table_bytes))
    per_stream = (3 * NA + 3 * NB + 16) * 4 + 2 * STATE_FLOATS * 4 + ns * 4
    if forced:
        per_stream += ns * 4 + 8          # target, preload, force_from
    return _bound(flops, weights + batch * per_stream)


def teacher_bound_ms(batch: int, ns: int) -> tuple:
    """The same for the teacher_advance kernel: no dual-FC, and its inputs
    are the conditions, the target and the state, its output the state."""
    flops = 2.0 * GRU_MACS * ns * batch
    per_stream = (3 * NA + 3 * NB + 16) * 4 + ns * 4 + 2 * STATE_FLOATS * 4
    return _bound(flops, GRU_WEIGHT_FLOATS * 4 + batch * per_stream)


def floor_ms(batch: int, ns: int, dual_fc: bool = True) -> float:
    """The least time of a sample-loop launch's multiply-adds as separate
    multiplies and adds (--fmad=false) at the card's peak instruction
    rate; dual_fc False: K4, which has none."""
    macs = (GRU_MACS + DFC_MACS * dual_fc) * ns * batch
    return 2.0 * macs / PEAK_LANE_INSTR * 1e3


def codec_speech(batch: int) -> np.ndarray:
    """The golden speech for each of `batch` streams, stream b rotated by
    CODEC_ROTATE * b samples, so the streams differ and each holds the
    whole file (50 packets)."""
    x = np.fromfile(SPEECH, np.int16).astype(np.float32)
    return np.stack([np.roll(x, -CODEC_ROTATE * b) for b in range(batch)])


def slice_args(args, n: int):
    """The first n streams of a state, condition or keyword dict."""
    import torch
    if isinstance(args, torch.Tensor):
        return args[:n].contiguous() if args.dim() else args
    if isinstance(args, dict):
        return {k: slice_args(v, n) for k, v in args.items()}
    return args


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


def host_ms(fn, reps: int, wait: bool = True) -> float:
    """Host clock around reps calls, synchronised before and after. With
    wait=False the clock is read when the calls return, before the device
    has finished: what the host spends issuing the work."""
    import torch
    fn()                                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if wait:
        torch.cuda.synchronize()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def plain_frames(sample_scan, variant, tables, state, conds, cfg):
    """The plain PyTorch version of the frame kernel `variant` on the
    card."""
    if variant in ("fuse", "opt"):
        return sample_scan.synthesize_frames_opt(
            tables, state, conds, cfg, pipeline_thr=variant == "opt")
    return sample_scan.synthesize_frames(tables, state, conds, cfg,
                                         flat=variant == "flat")


def compare_pcm(pcm_k, pcm_p) -> dict:
    pk, pp = pcm_k.cpu().numpy(), pcm_p.cpu().numpy()
    corr = float(np.corrcoef(pk.ravel(), pp.ravel())[0, 1]) \
        if pk.std() > 0 and pp.std() > 0 else float(np.array_equal(pk, pp))
    return {"max_abs_err": float(np.abs(pk - pp).max()),
            "exact_frac": float((pk == pp).mean()), "corr": corr}


class Recorder:
    """Stands in for sample_cuda.synth_samples and teacher_advance while an
    engine runs: passes every call through and keeps the arguments of the
    last call of each distinct (kernel, argument set, nsamples, batch) that
    launched (a call inside a CUDA graph's capture records nothing: its
    tensors are the graph's, which a replay overwrites)."""

    def __init__(self, sample_cuda):
        self.mod = sample_cuda
        self.calls = {}
        self._synth = sample_cuda.synth_samples
        self._teacher = sample_cuda.teacher_advance

    def __enter__(self):
        self.mod.synth_samples = self.synth_samples
        self.mod.teacher_advance = self.teacher_advance
        return self

    def __exit__(self, *exc):
        self.mod.synth_samples = self._synth
        self.mod.teacher_advance = self._teacher

    def synth_samples(self, tables, state, cond, cfg, nsamples, **kw):
        given = tuple(k for k in ("target", "preload", "force_from",
                                  "n_active") if kw.get(k) is not None)
        key = ("tf_" + kw.get("variant", "flat"), given, nsamples,
               cond["cond_a"].shape[0])
        if not _capturing():
            self.calls[key] = (tables, state, cond, cfg, nsamples, kw)
        return self._synth(tables, state, cond, cfg, nsamples, **kw)

    def teacher_advance(self, tables, state, cond, cfg, target):
        key = ("teacher", (), target.shape[1], cond["cond_a"].shape[0])
        if not _capturing():
            self.calls[key] = (tables, state, cond, cfg, target)
        return self._teacher(tables, state, cond, cfg, target)


class LpcTap:
    """Stands in for ops/dsp.lpc_from_cepstrum while the phases that count
    launches run: passes every call through and keeps each call's cepstra
    and results outside a CUDA graph's capture (a capture's tensors are the
    graph's, which a replay overwrites), so that each run's LPC can be held
    bit for bit against the plain version on the run's own cepstra
    (differ)."""

    def __init__(self, dsp):
        self.mod = dsp
        self.calls = []
        self._call = dsp.lpc_from_cepstrum

    def __enter__(self):
        self.mod.lpc_from_cepstrum = self.lpc_from_cepstrum
        return self

    def __exit__(self, *exc):
        self.mod.lpc_from_cepstrum = self._call

    def lpc_from_cepstrum(self, cepstrum):
        lpc, err = self._call(cepstrum)
        if cepstrum.device.type == "cuda" and not _capturing():
            self.calls.append((cepstrum[..., :18].clone(), lpc.clone(),
                               err.clone()))
        return lpc, err

    def differ(self) -> tuple:
        """(rows kept, rows whose lpc or err differ in any bit from the
        plain version's on the same call's cepstra). Each call is held on
        its own shape: cuBLAS and cuFFT may round a batch of another size
        differently, in the plain version as in the card's path."""
        rows = sum(c[..., 0].numel() for c, _, _ in self.calls)
        return rows, sum(lpc_differ(*call) for call in self.calls)


def _capturing() -> bool:
    import torch
    return torch.cuda.is_current_stream_capturing()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; this test needs "
                    "an NVIDIA card")
    if not os.path.isdir(os.path.join(REPO, "lpcnet_tpu_torch")):
        return fail(f"no lpcnet_tpu_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    from lpcnet_tpu_torch import convert, features, plc, verify
    from lpcnet_tpu_torch.kernels import (_build, burg_cuda, lpc_cuda,
                                          sample_cuda, sample_scan)
    from lpcnet_tpu_torch.models import lpcnet as lpcnet_model
    from lpcnet_tpu_torch.models import plc as plc_model
    from lpcnet_tpu_torch.ops import burg, dsp
    from lpcnet_tpu_torch.utils import graphs
    from lpcnet_tpu_torch.vocoder import Synthesizer

    # float32 means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    def zero_counts():
        for counts in (sample_cuda.launches, sample_cuda.plan_launches):
            for k in counts:
                counts[k] = 0
        burg_cuda.launches = 0
        lpc_cuda.launches = 0
        lpc_tap.calls.clear()
        graphs.captures.clear()
        graphs.replays.clear()

    def expect_plan(tag, B, n):
        """The launches of the sample loop in the run took the plan of
        their batch, n of them. Returns the (plan, cluster size) of the
        run's last launch, or (None, None) without one."""
        plan = "L" if B <= edge else "T"
        got = dict(sample_cuda.plan_launches)
        last = sample_cuda.last_plan if n else (None, None)
        print(f"[plan] {tag}: launches by plan {got}, the last under plan "
              f"{last[0]} with clusters of {last[1]} (plan {plan} "
              f"expected)")
        if got[plan] != n or sum(got.values()) != n or (n and last[0] != plan):
            raise RuntimeError(f"{tag}: expected {n} plan-{plan} launches, "
                               f"got {got}")
        return last

    lpc_tap = LpcTap(dsp)
    lpc_rows = {}

    def expect_lpc(tag, n):
        """The run called lpc_from_cepstrum n times on the card and
        launched the LPC kernel once a call, and every call's lpc and err
        are the plain version's on its own cepstra, bit for bit."""
        got, kept = lpc_cuda.launches, len(lpc_tap.calls)
        if got != n or kept != n:
            raise RuntimeError(f"{tag}: expected {n} LPC kernel launches, "
                               f"got {got} ({kept} calls)")
        rows, differ = lpc_tap.differ()
        lpc_tap.calls.clear()
        lpc_rows[tag] = rows
        print(f"[lpc] {tag}: {got} launches over {rows} rows, {differ} of "
              f"them differ from the plain version")
        if differ:
            raise RuntimeError(f"{tag}: {differ} rows of the LPC kernel "
                               f"differ from the plain version")

    t_start = time.perf_counter()

    def phase(name):
        """One line per phase: how far into the run it starts, so that the
        run can be kept well inside its time limit."""
        print(f"[clock] phase {name} at {time.perf_counter() - t_start:.1f} "
              f"s")

    # ---- 1. build
    phase("1 build")
    t0 = time.perf_counter()
    logs = _build.build(SOURCES)
    print(f"[build] {time.perf_counter() - t0:.1f} s [{card}]")
    for name, log in logs.items():
        print(f"[build] {name}: {log.strip() or 'already built'}")

    # The phases but 4j's bench and 4l count launches per call, record each
    # launch's arguments (Recorder) or hold and time eager launches, so their
    # entry points run eagerly (graphs.disabled()): a graphed entry point
    # launches its kernels from the host in its capture, never in a replay.
    # Phase 4l holds the graphs against eager chains.
    eager = contextlib.ExitStack()
    eager.enter_context(graphs.disabled())
    eager.enter_context(lpc_tap)

    # ---- 2. the synthesis path, each run held against the plain version
    phase("2 synthesis")
    dev = torch.device("cuda")
    clusters = sample_cuda.max_clusters(dev)
    edge = sample_cuda.TILE * clusters
    print(f"[plan] cudaOccupancyMaxActiveClusters of plan L (16-CTA "
          f"clusters): {clusters}; plan L for B <= {edge}, plan T above "
          f"[{card}]")
    params = convert.load_lpcnet(device=dev)
    # plan_ms: the one CUDA-event time of each (kernel, plan, batch);
    # plans: the (plan, cluster size) each run's launches took
    runs, gates, flat_ref, timing, inputs = {}, {}, {}, {}, {}
    plan_ms, plans = {}, {}
    for variant, B, frames in PATHS + (("flat", edge, BOUNDARY_FRAMES),):
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
        expect_lpc(tag, 1)
        plans[(variant, B)] = expect_plan(tag, B, frames)
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
        inputs[(variant, B)] = (tables, st0, conds)
        st_k, pcm_k = sample_cuda.synthesize_frames(tables, st0, c, cfg,
                                                    variant=variant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, pcm_p = plain_frames(sample_scan, variant, tables, st0, c, cfg)
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

        # flat and base on the same inputs give the same bits, and the
        # fused variants the base kernel's, GRU states included
        if variant == "flat":
            flat_ref[B] = (tables, st0, c, st_k, pcm_k)
        elif variant in ("fuse", "opt"):
            sb, pb = sample_cuda.synthesize_frames(tables, st0, c, cfg,
                                                   variant="base")
            same = {k: torch.equal(st_k[k], sb[k])
                    for k in ("last_exc", "rng", "gru_a", "gru_b")}
            same["pcm"] = torch.equal(pcm_k, pb)
            print(f"[kernel] {tag}: bit-identical to the base kernel on the "
                  f"same inputs: {same}")
            if not all(same.values()):
                return fail(f"{tag}: {variant} and base kernels differ")
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
        plan_ms[(variant, plans[(variant, B)][0], B)] = timing[(variant, B)]
        bound = sample_bound_ms(B, FS, False)
        print(f"[time] sample_frame_{variant} B={B}: "
              f"{timing[(variant, B)]:.4f} ms per frame (CUDA events), bound "
              f"{bound[0]:.6f} ms ({bound[1]}) [{card}]")

    # ---- 2b. the bf16 instances of K1, K2 and K5: one frame through the
    # entry point per variant at B=1024 (plan T), then each instance under
    # plan L (B=1, the boundary) and plan T (B=1024) on the run's first
    # streams against the plain loop on the same bf16 tables and against
    # the float32 instance on the tables widened: exact
    phase("2b bf16")
    big = PATHS[0][1]
    keys = ("cond_a", "cond_b", "lpc")
    tables32, st_big, conds_big = inputs[("flat", big)]
    ck_big = {k: conds_big[k][:, :TIME_FRAMES].contiguous() for k in keys}
    feats1 = tiled_features(big, 1)
    bf16_runs, bf16_gates, bf16_ms = {}, {}, {}
    for variant in sample_cuda.FRAME_VARIANTS:
        vb = Synthesizer(params=params, device=dev, variant=variant,
                         tables="bf16")
        cfg, tb = vb.cfg, vb.frame_tables
        wide = {k: v for k, v in tb.items() if not k.startswith("fused")}
        wide.update({k: tb[k].float() for k in sample_scan.TABLES})
        counter = variant + "_bf16"
        tag = f"{counter} B={big}"
        vb.synthesize(vb.reset(big, per_stream_rng=True), feats1)    # warm
        torch.cuda.synchronize()
        zero_counts()
        st0 = vb.reset(big, per_stream_rng=True)
        _, pcm = vb.synthesize(st0, feats1)
        torch.cuda.synchronize()
        counts = dict(sample_cuda.launches)
        print(f"[bf16] Synthesizer(variant={variant!r}, tables='bf16') "
              f"B={big} x 1 frame: launches {counts}")
        if counts[counter] != 1 or sum(counts.values()) != 1:
            return fail(f"{tag}: expected 1 {counter} launch, got {counts}")
        expect_lpc(tag, 1)
        expect_plan(tag, big, 1)
        bf16_runs[variant] = counts[counter]
        c = {k: v.contiguous() for k, v in vb.conditions(feats1).items()
             if k in keys}
        t0 = time.perf_counter()
        st_p, pcm_p = plain_frames(sample_scan, variant, tb, st0, c, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = 0.0
        for plan, B in (("T", big), ("L", 1), ("L", edge)):
            sB, cB = slice_args(st0, B), slice_args(c, B)
            with sample_cuda._plan_forced(dev, plan):
                st_k, pcm_k = sample_cuda.synthesize_frames(
                    tb, sB, cB, cfg, variant=variant)
                took = sample_cuda.last_plan[0]
                st_w, pcm_w = sample_cuda.synthesize_frames(
                    wide, sB, cB, cfg, variant=variant)
            torch.cuda.synchronize()
            fields = ("last_exc", "rng", "gru_a", "gru_b")
            same_p = {k: torch.equal(st_k[k], st_p[k][:B]) for k in fields}
            same_p["pcm"] = torch.equal(pcm_k, pcm_p[:B])
            same_w = {k: torch.equal(st_k[k], st_w[k]) for k in fields}
            same_w["pcm"] = torch.equal(pcm_k, pcm_w)
            in_path = plan != "T" or torch.equal(pcm, pcm_k)
            err = max(err, float((pcm_k - pcm_p[:B]).abs().max()))
            print(f"[bf16] {counter} plan {took} B={B}: equal to the plain "
                  f"loop on the bf16 tables {same_p}, to the float32 "
                  f"instance on the tables widened {same_w}; the run's pcm "
                  f"is the kernel's {in_path}")
            if took != plan or not (all(same_p.values())
                                    and all(same_w.values()) and in_path):
                return fail(f"{counter} plan {plan} B={B}: the bf16 kernel "
                            f"is not the plain loop's or the float32 "
                            f"instance's bits")
            s0B, ckB = slice_args(st_big, B), slice_args(ck_big, B)
            with sample_cuda._plan_forced(dev, plan):
                ms16 = cuda_ms(lambda: sample_cuda.synthesize_frames(
                    tb, s0B, ckB, cfg, variant=variant), 3) / TIME_FRAMES
                ms32 = cuda_ms(lambda: sample_cuda.synthesize_frames(
                    tables32, s0B, ckB, cfg, variant=variant), 3) \
                    / TIME_FRAMES
            bf16_ms[(variant, plan, B)] = (ms16, ms32)
            bound16 = sample_bound_ms(B, FS, False, table_bytes=2)
            print(f"[time] {counter} plan {plan} B={B}: {ms16:.4f} ms per "
                  f"frame (CUDA events), the float32 instance {ms32:.4f} on "
                  f"the same inputs; bound {bound16[0]:.6f} ms "
                  f"({bound16[1]}), float32 "
                  f"{sample_bound_ms(B, FS, False)[0]:.6f} [{card}]")
        bf16_gates[variant] = {"max_abs_err": err, "plain_ms": plain_ms}

    # ---- 2c. the codec end to end: pcm -> packets (the encode command's
    # chunked steps) -> features (decode_packets) -> speech (synthesize in
    # 64-frame calls, float32 and bf16 tables)
    phase("2c codec")
    from lpcnet_tpu_torch import cli
    from lpcnet_tpu_torch.codec import codec
    cbs, cbs_cpu = cli.load_codebooks(None, dev), cli.load_codebooks(None,
                                                                   "cpu")
    n_sf = np.fromfile(SPEECH, np.int16).size // (4 * FS)
    codec_runs = {}
    for B in CODEC_BATCHES:
        speech = codec_speech(B)
        padded = np.stack([cli._pad_to_chunks(x, 4 * n_sf) for x in speech])
        pcm_dev = torch.as_tensor(padded, device=dev)
        cli.encode_chunks(cbs, pcm_dev[:, :CHUNK_FRAMES * FS],
                          CHUNK_FRAMES // 4)                           # warm
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        packets = cli.encode_chunks(cbs, pcm_dev, n_sf)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        enc_counts = sum(sample_cuda.launches.values())
        # each chunk: the feature pass and the quantized features' LPC
        expect_lpc(f"codec encode B={B}",
                   2 * -(-n_sf // (CHUNK_FRAMES // 4)))
        rows = [r for r in CODEC_CPU_ROWS if r < B]
        ref = cli.encode_chunks(cbs_cpu, torch.as_tensor(padded[rows]), n_sf)
        got = packets[rows].cpu()
        whole = float((got == ref).all(-1).float().mean())
        byts = float((got == ref).float().mean())
        print(f"[codec] encode B={B} x {n_sf} packets on the card: "
              f"{tuple(packets.shape)} {packets.dtype}; against the CPU "
              f"encode of streams {rows}: whole packets equal {whole} (gate "
              f">= {CODEC_GATE_PACKETS}), bytes equal {byts} (gate >= "
              f"{CODEC_GATE_BYTES}); sample-kernel launches {enc_counts}")
        print(f"[codec] encode B={B}: {t_enc * 1e3 / n_sf:.4f} ms per packet"
              f" of all {B} streams, {t_enc * 1e3 / (n_sf * B):.6f} ms per "
              f"stream-packet (host clock, synchronised) [{card}]")
        if packets.shape != (B, n_sf, 8) or enc_counts \
                or whole < CODEC_GATE_PACKETS or byts < CODEC_GATE_BYTES:
            return fail(f"codec B={B}: the card's packets are not the CPU "
                        f"encode's")
        mem0 = torch.zeros((B, 18), device=dev)
        codec.decode_packets(cbs, packets[:, :1], mem0)                # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, _ = codec.decode_packets(cbs, packets, mem0)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        ref_f, _ = codec.decode_packets(cbs_cpu, got, torch.zeros((len(rows),
                                                                   18)))
        derr = float((feats[rows].cpu() - ref_f).abs().max())
        print(f"[codec] decode_packets B={B}: {t_dec * 1e3:.4f} ms for "
              f"{n_sf} packets (host clock, synchronised), features "
              f"{tuple(feats.shape)}, max |d| against the CPU decode {derr} "
              f"(gate <= 1e-5) [{card}]")
        if feats.shape != (B, 4 * n_sf, 36) or not derr <= 1e-5:
            return fail(f"codec B={B}: decoded features differ from the "
                        f"CPU decode")
        T = feats.shape[1]
        for tables in ("f32", "bf16"):
            v = Synthesizer(params=params, device=dev, tables=tables)
            cfg = v.cfg
            counter = "flat" if tables == "f32" else "flat_bf16"
            tag = f"codec synthesis tables={tables} B={B}"
            v.synthesize(v.reset(B, per_stream_rng=True), feats[:, :2])
            torch.cuda.synchronize()
            zero_counts()
            st0 = v.reset(B, per_stream_rng=True)
            st, outs = st0, []
            t0 = time.perf_counter()
            for f0 in range(0, T, CHUNK_FRAMES):
                st, out = v.synthesize(st, feats[:, f0:f0 + CHUNK_FRAMES])
                outs.append(out)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(sample_cuda.launches)
            o = torch.cat(outs, dim=1).cpu().numpy()
            print(f"[codec] {tag} x {T} frames in {CHUNK_FRAMES}-frame "
                  f"calls: launches {counts}; pcm {o.shape}, finite "
                  f"{bool(np.isfinite(o).all())}, max |pcm| "
                  f"{np.abs(o).max()}")
            if counts[counter] != T or sum(counts.values()) != T:
                return fail(f"{tag}: expected {T} {counter} launches, got "
                            f"{counts}")
            expect_lpc(tag, -(-T // CHUNK_FRAMES))
            expect_plan(tag, B, T)
            if o.shape != (B, T * FS) or not np.isfinite(o).all() \
                    or not 0 < np.abs(o).max() <= 32767:
                return fail(f"{tag}: pcm is not int16-range audio")
            codec_runs[(B, tables)] = counts[counter]
            print(f"[codec] {tag}: {wall * 1e3 / T:.4f} ms per frame (host "
                  f"clock, with conditioning), RT factor "
                  f"{B * T * 0.01 / wall:.1f}x [{card}]")
            conds = v.conditions(feats[:, :CHUNK_FRAMES])
            c = {k: conds[k][:, :GATE_FRAMES].contiguous() for k in keys}
            st_k, pcm_k = sample_cuda.synthesize_frames(v.frame_tables, st0,
                                                        c, cfg)
            st_p, pcm_p = sample_scan.synthesize_frames(v.frame_tables, st0,
                                                        c, cfg, flat=True)
            torch.cuda.synchronize()
            g = compare_pcm(pcm_k, pcm_p)
            rng_ok = torch.equal(st_k["rng"], st_p["rng"])
            same_state = all(torch.equal(st_k[k], st_p[k]) for k in st_p)
            in_path = bool((torch.cat(outs, 1)[:, :GATE_FRAMES * FS]
                            == pcm_k).all())
            print(f"[codec] {tag} vs plain ({GATE_FRAMES} frames of this "
                  f"run): rng exact {rng_ok}, pcm exact fraction "
                  f"{g['exact_frac']:.6f}, corr {g['corr']:.8f}, max |d| "
                  f"{g['max_abs_err']}, whole state equal {same_state}; the "
                  f"run's pcm is the kernel's {in_path}")
            if not (rng_ok and g["exact_frac"] >= GATE_EXACT
                    and g["corr"] >= GATE_CORR and in_path):
                return fail(f"{tag}: kernel disagrees with the plain "
                            f"version")

    # ---- 2d. DRED end to end: features -> latents -> payloads -> features
    phase("2d dred")
    dred_out = dred_phase(dev, card)

    # ---- 3. the PLC path: PLCEngine.run, one K3 launch per step
    phase("3 plc")
    plc_params = convert.load_plc(device=dev)
    calls, plc_runs, engines, burg_runs, lpc_runs = {}, {}, {}, {}, {}
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
        print(f"[plc] {tag} x {frames} frames: launches {counts}, Burg "
              f"{burg_cuda.launches}; lost "
              f"{lost.mean():.3f} of the frames, blend {blend.mean():.3f}; "
              f"out {o.shape}, finite {bool(np.isfinite(o).all())}, max "
              f"|out| {np.abs(o).max()}, good rows equal input "
              f"{bool((o[good] == pcm_in[good]).all())}")
        if counts["tf_" + variant] != frames \
                or sum(counts.values()) != frames:
            return fail(f"{tag}: expected {frames} tf_{variant} launches and"
                        f" nothing else, got {counts}")
        if burg_cuda.launches != frames:
            return fail(f"{tag}: expected {frames} Burg kernel launches (one"
                        f" a step), got {burg_cuda.launches}")
        burg_runs[(variant, B)] = burg_cuda.launches
        expect_lpc(tag, 2 * frames)        # the feature pass, the frame net
        lpc_runs[(variant, B)] = 2 * frames
        plans[("tf_" + variant, B)] = expect_plan(tag, B, frames)
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

    phase("3b burg")
    burg_ms = burg_phase(dev, card)
    phase("3c lpc")
    lpc_ms = lpc_phase(dev, card)

    # ---- 4. the non-causal path: 4 K3 and 3 K4 launches per step
    phase("4 noncausal")
    nc_counts, nc_step_ms = {}, {}
    for B, frames in NONCAUSAL_PATHS:
        nc = plc.NonCausalPLCEngine(params, plc_params, device=dev)
        pcm_in, lost = tiled_speech(B, frames), loss_flags(B, frames)
        if B == 1:
            lost[0, 1] = True       # one stream: make sure it loses a frame
        nc.run(nc.init_state(B), pcm_in[:, :FS], lost[:, :1])        # warm
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
        tag = f"NonCausalPLCEngine B={B}"
        print(f"[noncausal] {tag} x {frames} frames: launches {counts}, "
              f"Burg {burg_cuda.launches}; out "
              f"{o.shape}, finite {bool(np.isfinite(o).all())}, max |out| "
              f"{np.abs(o).max()}; {int(clean.sum())} streams without a loss"
              f" equal their input delayed by 80 samples: {delayed_ok}")
        if counts["tf_flat"] != 4 * frames \
                or counts["teacher"] != 3 * frames \
                or sum(counts.values()) != 7 * frames:
            return fail(f"{tag}: expected {4 * frames} tf_flat and "
                        f"{3 * frames} teacher launches, got {counts}")
        if burg_cuda.launches != frames:
            return fail(f"{tag}: expected {frames} Burg kernel launches (one"
                        f" a step), got {burg_cuda.launches}")
        expect_lpc(tag, 8 * frames)
        plans[("teacher", B)] = expect_plan(tag, B, 7 * frames)
        if o.shape != (B, frames * FS) or not np.isfinite(o).all() \
                or np.abs(o).max() > 32767 or not delayed_ok:
            return fail(f"{tag}: output is not the expected audio")
        if not (lost.any() and np.abs(o).max() > 0):
            return fail(f"{tag}: nothing was concealed")
        nc_counts[B] = counts
        nc_step_ms[B] = wall * 1e3 / frames
        print(f"[noncausal] {tag}: {wall * 1e3 / frames:.4f} ms per step "
              f"(host clock), RT factor {B * frames * 0.01 / wall:.1f}x "
              f"[{card}]")

    # ---- 4b. the other synthesis modes: one K3 launch per frame
    phase("4b modes")
    B, frames = STREAMING_PATH
    v = Synthesizer(params=params, device=dev)
    look = v.cfg.lookahead
    feats = tiled_features(B, frames)
    v.synthesize_streaming(v.reset_streaming(B, True), feats[:, :1])  # warm
    torch.cuda.synchronize()
    zero_counts()
    with Recorder(sample_cuda) as rec:
        t0 = time.perf_counter()
        st, head = v.synthesize_streaming(v.reset_streaming(B, True),
                                          feats[:, :look])
        fresh = v.reset(B, per_stream_rng=True)
        untouched = all(torch.equal(st["synth"][k], fresh[k]) for k in fresh)
        st, tail = v.synthesize_streaming(st, feats[:, look:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(sample_cuda.launches)
    calls.update(rec.calls)
    o = tail.cpu().numpy()
    silent = not bool(head.any())
    print(f"[modes] synthesize_streaming B={B} x {frames} frames: launches "
          f"{counts}; the first {look} frames are silence {silent} and leave "
          f"the sample state and RNG a fresh reset's {untouched}; then pcm "
          f"{o.shape}, finite {bool(np.isfinite(o).all())}, max |pcm| "
          f"{np.abs(o).max()}; {wall * 1e3 / frames:.4f} ms per frame (host "
          f"clock) [{card}]")
    if counts["tf_flat"] != frames or sum(counts.values()) != frames:
        return fail(f"streaming: expected {frames} tf_flat launches and "
                    f"nothing else, got {counts}")
    expect_lpc("streaming", frames)
    expect_plan("streaming", B, frames)
    if not (silent and untouched and o.shape == (B, (frames - look) * FS)
            and np.isfinite(o).all() and 0 < np.abs(o).max() <= 32767):
        return fail("streaming: output is not silence, then audio")
    mode_counts = {"streaming": counts["tf_flat"]}

    B, frames = TEACHER_PATH
    feats = tiled_features(B, frames)
    target = tiled_speech(B, frames)
    preload = np.random.RandomState(9).randint(0, FS + 1, (B, frames))
    zero_counts()
    with Recorder(sample_cuda) as rec:
        st, out = v.synthesize_teacher(v.reset(B, per_stream_rng=True),
                                       feats, target, preload)
        torch.cuda.synchronize()
    counts = dict(sample_cuda.launches)
    calls.update(rec.calls)
    o = out.cpu().numpy()
    forced = (np.arange(FS)[None, None, :] < preload[:, :, None]).reshape(
        B, frames * FS)
    forced_ok = bool((o[forced] == target[forced]).all())
    print(f"[modes] synthesize_teacher B={B} x {frames} frames: launches "
          f"{counts}; {forced.mean():.3f} of the samples forced, equal to "
          f"the target {forced_ok}; finite {bool(np.isfinite(o).all())}, "
          f"max |pcm| {np.abs(o).max()}")
    if counts["tf_flat"] != frames or sum(counts.values()) != frames:
        return fail(f"teacher: expected {frames} tf_flat launches and "
                    f"nothing else, got {counts}")
    expect_lpc("teacher", 1)
    expect_plan("teacher", B, frames)
    if not (forced_ok and np.isfinite(o).all()
            and np.abs(o).max() <= 32767):
        return fail("teacher: forced samples differ from the target")
    mode_counts["teacher"] = counts["tf_flat"]

    # ---- 4c. the strict engine: 8 K3 launches per step, no K4
    phase("4c strict")
    strict_runs, strict_engines = {}, {}
    for B, frames in STRICT_PATHS:
        eng = plc.StrictCausalPLCEngine(params, plc_params, device=dev)
        pcm_in, lost = tiled_speech(B, frames), loss_flags(B, frames)
        if B == 1:
            lost[0, 3:5] = True     # one stream: make sure it loses frames
        eng.run(eng.init_state(B), pcm_in[:, :FS], lost[:, :1])      # warm
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
        tag = f"StrictCausalPLCEngine B={B}"
        blend = np.concatenate([np.zeros((B, 1), bool), lost[:, :-1]], 1) \
            & ~lost
        good = np.repeat(~lost & ~blend, FS, axis=1)
        half2 = np.repeat(blend, FS, axis=1) \
            & (np.arange(frames * FS) % FS >= FS // 2)[None, :]
        good_ok = bool((o[good] == pcm_in[good]).all())
        blend_ok = bool((o[half2] == pcm_in[half2]).all())
        print(f"[strict] {tag} x {frames} frames: launches {counts}, Burg "
              f"{burg_cuda.launches}; lost "
              f"{lost.mean():.3f} of the frames, blend {blend.mean():.3f}; "
              f"out {o.shape}, finite {bool(np.isfinite(o).all())}, max "
              f"|out| {np.abs(o).max()}, good rows equal input {good_ok}, "
              f"blend rows equal input in their second half {blend_ok}")
        if counts["tf_flat"] != 8 * frames \
                or sum(counts.values()) != 8 * frames:
            return fail(f"{tag}: expected {8 * frames} tf_flat launches (8 "
                        f"per step) and nothing else, got {counts}")
        if burg_cuda.launches != frames:
            return fail(f"{tag}: expected {frames} Burg kernel launches (one"
                        f" a step), got {burg_cuda.launches}")
        expect_lpc(tag, 11 * frames)
        expect_plan(tag, B, 8 * frames)
        if o.shape != (B, frames * FS) or not np.isfinite(o).all() \
                or np.abs(o).max() > 32767:
            return fail(f"{tag}: output is not finite int16-range audio")
        if not (good_ok and blend_ok):
            return fail(f"{tag}: a good frame did not pass through")
        if not (lost.any() and blend.any()
                and np.abs(o[np.repeat(lost, FS, axis=1)]).max() > 0):
            return fail(f"{tag}: nothing was concealed")
        for given, ns, _ in STRICT_LAUNCHES:
            if ("tf_flat", given, ns, B) not in rec.calls:
                return fail(f"{tag}: no launch with {given}, ns={ns}")
        strict_runs[B] = counts["tf_flat"]
        strict_engines[B] = (eng, st, pcm_in, lost)
        print(f"[strict] {tag}: {wall * 1e3 / frames:.4f} ms per step (host "
              f"clock, synchronised at the end), RT factor "
              f"{B * frames * 0.01 / wall:.1f}x [{card}]")

    # ---- 4d. DRED feeding the PLC engine's FEC queue, one K3 launch per
    # step, held in phase 5
    phase("4d dred-plc")
    with Recorder(sample_cuda) as rec:
        dred_plc = dred_plc_phase(dev, card, dred_out, params, plc_params,
                                  zero_counts, expect_plan, expect_lpc)
    calls.update(rec.calls)

    # ---- 4e. the DOT_PROD emulation; 4f. the inference tools
    phase("4e dotprod")
    dotprod_phase(dev, card, sample_cuda)
    phase("4f tools")
    tools_phase(card)
    # ---- 4g. training; no hand-written kernel on its path
    phase("4g train")
    before = dict(sample_cuda.launches)
    eager.close()            # the train steps run graphed, as a user runs them
    train_phase(dev, card)
    eager.enter_context(graphs.disabled())
    if dict(sample_cuda.launches) != before:
        raise RuntimeError("train: the training path launched a sample "
                           "kernel")
    # ---- 4h. stream- and data-parallel worlds, each rank in its own
    # process; 4i. the first traces of the device's idle share
    phase("4h dp")
    zero_counts()
    dp = dp_phase(dev, card, params, edge)
    print(f"[dp] this process's launches (the single-process reference, "
          f"warm-up included): {dict(sample_cuda.launches)}")
    if sample_cuda.launches["flat"] != 2 * DP_FRAMES \
            or sum(sample_cuda.launches.values()) != 2 * DP_FRAMES:
        return fail(f"dp: the reference run launched "
                    f"{dict(sample_cuda.launches)}")
    phase("4i profile")
    with Recorder(sample_cuda) as rec:
        profile_phase(dev, card, params, engines[("flat", 1)])
    calls.update(rec.calls)

    # ---- 4j. verify_on_device: every kernel against its oracle, the strict
    # engine through the kernels against itself through the plain loops;
    # then the bench on that report, and the evaluations
    phase("4j verify")
    t0 = time.perf_counter()
    zero_counts()
    report = verify.verify_on_device(plc_frames=VERIFY_STRICT_FRAMES,
                                     device=dev)
    torch.cuda.synchronize()
    gates_v = {k: g["measured"] for k, g in report.items()
               if isinstance(g, dict) and "ok" in g}
    print(f"[verify] {len(gates_v)} gates passed in "
          f"{time.perf_counter() - t0:.1f} s, launches "
          f"{dict(sample_cuda.launches)}: {json.dumps(gates_v)} [{card}]")
    sp = report["strict_plc_step"]["measured"]
    if not (report.get("ok") and sp["lost_steps"] and sp["blend_steps"]
            and sp["good_steps"]):
        return fail(f"verify: the strict run lacks a kind of step: {sp}")
    phase("4j bench")
    eager.close()            # the bench times the graphed entry points
    with Recorder(sample_cuda) as rec:
        bench_runs = bench_phase(dev, card, report, zero_counts)
    calls.update(rec.calls)
    eager.enter_context(graphs.disabled())
    phase("4j eval")
    eval_runs = eval_phase(dev, card, zero_counts)
    # ---- 4k. the graft entry's step, eager and captured as a CUDA graph,
    # and its multi-card dry run
    phase("4k graft")
    graft = graft_phase(dev, card, zero_counts, edge)
    # ---- 4l. every graphed entry point against its eager chain
    phase("4l graphs")
    eager.close()
    graphs_phase(dev, card, params, plc_params, zero_counts)
    eager.enter_context(graphs.disabled())

    # ---- 5. every launched (kernel, argument set, nsamples, batch) held
    # against its plain version on the last launch's own arguments
    phase("5 holds")
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

    def hold_teacher(tag, tables, state, cond, cfg, target):
        """K4 against its plain version and against a fully forced K3
        launch: every state field exact."""
        st_k, _ = sample_cuda.teacher_advance(tables, state, cond, cfg,
                                              target)
        st_3, pcm_3 = sample_cuda.synth_samples(tables, state, cond, cfg,
                                                target.shape[1],
                                                target=target)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, _ = sample_scan.teacher_advance(tables, state, cond, cfg,
                                              target)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(float((st_k[k] - st_p[k]).abs().max().cpu())
                  for k in st_p)
        same_p = {k: torch.equal(st_k[k], st_p[k]) for k in st_p}
        same_3 = {k: torch.equal(st_k[k], st_3[k]) for k in st_p}
        print(f"[hold] {tag}: every state field equal to plain "
              f"{all(same_p.values())} {same_p}, to forced synth_samples "
              f"{all(same_3.values())} {same_3} (forced pcm is the target "
              f"{torch.equal(pcm_3, target)}); max |d| {err}; plain "
              f"{plain_ms:.1f} ms (host clock) [{card}]")
        held["teacher"].append({"max_abs_err": err, "plain_ms": plain_ms,
                                "ns": target.shape[1],
                                "batch": target.shape[0]})
        return all(same_p.values()) and all(same_3.values()) \
            and torch.equal(pcm_3, target)

    for key in sorted(calls, key=str):
        name, given, ns, B = key
        tag = (f"{name} ({'+'.join(given) or 'free-run'}, ns={ns}, B={B}) "
               f"vs plain")
        if name == "teacher":
            if not hold_teacher(tag, *calls[key]):
                return fail(f"{tag}: teacher_advance disagrees with its plain"
                            f" version or with forced synth_samples")
        elif not hold_synth(tag, *calls[key]):
            return fail(f"{tag}: kernel disagrees with the plain version")
    big = PLC_PATHS[0][1]
    for B in (big, 1):
        if ("teacher", (), FS, B) not in calls:
            return fail(f"no teacher_advance launch of ns={FS} at B={B}")

    # ---- 6. times
    phase("6 times")
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
            plan_ms[("tf_" + variant, plans[("tf_" + variant, B)][0],
                     B)] = ktime[("tf_" + variant, B)]
            bound = sample_bound_ms(B, ns, True)
            print(f"[time] synth_samples_{variant} (target+force_from, "
                  f"ns={ns}) B={B}: {ktime[('tf_' + variant, B)]:.4f} ms per"
                  f" launch (CUDA events), bound {bound[0]:.6f} ms "
                  f"({bound[1]}) [{card}]")
        # K4: one launch per call; the host clock times the whole call
        teacher_args = calls[("teacher", (), FS, B)]
        ktime[("teacher", B)] = cuda_ms(
            lambda: sample_cuda.teacher_advance(*teacher_args), 5)
        plan_ms[("teacher", plans[("teacher", B)][0], B)] = ktime[
            ("teacher", B)]
        t_all = host_ms(lambda: sample_cuda.teacher_advance(*teacher_args),
                        5)
        bound = teacher_bound_ms(B, FS)
        print(f"[time] teacher_advance (ns={FS}) B={B}: "
              f"{ktime[('teacher', B)]:.4f} ms per launch (CUDA events), "
              f"bound {bound[0]:.6f} ms ({bound[1]}); the whole "
              f"teacher_advance call {t_all:.4f} ms (host clock, "
              f"synchronised) [{card}]")

    # K1 (flat) and K5 (fuse, opt), one frame per launch, K3 (flat, the
    # PLCEngine argument set) and K4, 160 samples, under each plan that can
    # take the batch: B=1, the boundary, B=1024 (plan L cannot take 1024
    # streams); what the runs above timed already is not timed again
    k3_args = calls[("tf_flat", ("target", "force_from"), FS, big)]
    k4_args = calls[("teacher", (), FS, big)]
    for B in (1, edge, big):
        tables, st0, conds = inputs[("flat", 1 if B == 1 else big)]
        ck = {k: conds[k][:B, :TIME_FRAMES].contiguous()
              for k in ("cond_a", "cond_b", "lpc")}
        s0 = slice_args(st0, B)
        tables3, state3, cond3, cfg3, ns3, kw3 = k3_args
        state3, cond3, kw3 = (slice_args(a, B) for a in (state3, cond3, kw3))
        tables4, state4, cond4, cfg4, target4 = k4_args
        state4, cond4, target4 = (slice_args(a, B)
                                  for a in (state4, cond4, target4))

        def frame_fn(variant):
            return lambda: sample_cuda.synthesize_frames(
                tables, s0, ck, cfg, variant=variant)

        timed = {
            "flat": frame_fn("flat"), "fuse": frame_fn("fuse"),
            "opt": frame_fn("opt"),
            "tf_flat": lambda: sample_cuda.synth_samples(
                tables3, state3, cond3, cfg3, ns3, **kw3),
            "teacher": lambda: sample_cuda.teacher_advance(
                tables4, state4, cond4, cfg4, target4)}
        for plan in ("L", "T") if B <= edge else ("T",):
            for name, fn in timed.items():
                if (name, plan, B) in plan_ms:
                    continue
                with sample_cuda._plan_forced(dev, plan):
                    frame = name in sample_cuda.FRAME_VARIANTS
                    plan_ms[(name, plan, B)] = cuda_ms(fn, 3) / (
                        TIME_FRAMES if frame else 1)
                    if sample_cuda.last_plan[0] != plan:
                        return fail(f"times: plan {sample_cuda.last_plan}, "
                                    f"not {plan}")
            for name in timed:
                if name == "teacher":
                    bound, floor = (teacher_bound_ms(B, FS)[0],
                                    floor_ms(B, FS, dual_fc=False))
                else:
                    bound, floor = (sample_bound_ms(B, FS, name == "tf_flat")
                                    [0], floor_ms(B, FS))
                print(f"[time] {name} plan {plan} B={B}: "
                      f"{plan_ms[(name, plan, B)]:.4f} ms per 160-sample "
                      f"launch (CUDA events); floor {floor:.6f} ms "
                      f"(--fmad=false issue), bound {bound:.6f} ms [{card}]")
    tables, st0, conds = inputs[("base", big)]      # 4 frames
    ck = {k: conds[k][:edge].contiguous() for k in ("cond_a", "cond_b", "lpc")}
    s0 = slice_args(st0, edge)
    with sample_cuda._plan_forced(dev, "L"):
        plan_ms[("base", "L", edge)] = cuda_ms(
            lambda: sample_cuda.synthesize_frames(tables, s0, ck, cfg,
                                                  variant="base"), 3) / 4
    print(f"[time] base plan L B={edge}: {plan_ms[('base', 'L', edge)]:.4f} "
          f"ms per launch (CUDA events) [{card}]")

    # the phase split of the step under each plan: the frame kernel and K4
    print_phases(sample_cuda, Synthesizer(params=params, device=dev), card,
                 (("L", 1), ("L", edge), ("T", big), ("T", 1)))
    print_phases(sample_cuda, Synthesizer(params=params, device=dev), card,
                 (("L", 1), ("T", big)), teacher=True)

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
                mode="single", return_mid=True),
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

    # the strict step's split: its 10 frame_net_step calls, its 8 launches
    # (replayed from the run's last arguments, CUDA events), the rest of
    # what the host issues
    strict_ms = {}
    for B, _ in STRICT_PATHS:
        eng, st, pcm_in, lost = strict_engines[B]
        fr = torch.as_tensor(pcm_in[:, -FS:], device=dev)
        lo = torch.as_tensor(lost[:, -1], device=dev)
        feats36 = torch.zeros((B, 36), device=dev)
        replay = [(calls[("tf_flat", given, ns, B)], n)
                  for given, ns, n in STRICT_LAUNCHES]

        def fnet10():
            for _ in range(10):
                lpcnet_model.frame_net_step(eng.params, eng.tables,
                                            st["fnet"], feats36, eng.cfg)

        def launches8():
            for (tables, state, cond, cfg, ns, kw), n in replay:
                for _ in range(n):
                    sample_cuda.synth_samples(tables, state, cond, cfg, ns,
                                              **kw)

        t_step = host_ms(lambda: eng.step(st, fr, lo), 3)
        t_issue = host_ms(lambda: eng.step(st, fr, lo), 3, wait=False)
        t_fnet = host_ms(fnet10, 3)
        t_kern = cuda_ms(launches8, 3)
        strict_ms[B] = t_step
        print(f"[split] StrictCausalPLCEngine step B={B}, ms: whole step "
              f"{t_step:.3f} (host clock, synchronised); the host issues "
              f"for {t_issue:.3f} before it waits (its own timing); its 10 "
              f"frame_net_step calls alone {t_fnet:.3f} (host clock), its 8 "
              f"launches alone {t_kern:.3f} (CUDA events; they run beside "
              f"the host's issuing), the rest of the issuing "
              f"{t_issue - t_fnet:.3f} [{card}]")

    # ---- the kernels' line
    phase("kernels line")
    def plan_keys(name):
        """The plan and cluster size that the kernel's B=1024 run took, and
        its time at the plan boundary under plan L."""
        plan, cluster = plans[(name, big)]
        return {"plan": plan, "cluster": cluster,
                "ms_boundary": plan_ms.get((name, "L", edge))}

    kernels = []
    big = PATHS[0][1]
    bound, bound_by = sample_bound_ms(big, FS, False)
    for variant, line, source in (("flat", 469, "sample_frame"),
                                  ("base", 440, "sample_frame"),
                                  ("fuse", 501, "sample_frame_opt"),
                                  ("opt", 501, "sample_frame_opt")):
        g, g1 = gates[(variant, big)], gates[(variant, 1)]
        kernels.append({
            "name": f"sample_frame_{variant}", "route": "cuda",
            "source": f"lpcnet_tpu_torch/csrc/{source}.cu",
            "replaces": f"lpcnet_tpu/kernels/sample_pallas.py:{line}",
            "launches": runs[(variant, big)],
            "max_abs_err": max(g["max_abs_err"], g1["max_abs_err"]),
            "exact_frac": min(g["exact_frac"], g1["exact_frac"]),
            "corr": min(g["corr"], g1["corr"]), "tolerance": TOLERANCE,
            "ms": timing[(variant, big)], "plain_ms": g["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "batch": big, "launches_b1": runs[(variant, 1)],
            "ms_b1": timing[(variant, 1)], "plain_ms_b1": g1["plain_ms"],
            "bound_ms_b1": sample_bound_ms(1, FS, False)[0],
            **plan_keys(variant)})
    kernels[0]["launches_codec"] = codec_runs[(big, "f32")]
    kernels[0].update(bench_runs["k1"])
    kernels[0]["launches_eval_lpcnet"] = eval_runs["launches"]
    kernels[0].update({f"launches_dp_{k}": d["launches"]
                       for k, d in dp.items()})
    kernels[0]["max_abs_err_dp"] = max(d["max_abs_err"] for d in dp.values())
    kernels[0].update(graft)
    bound, bound_by = sample_bound_ms(big, FS, False, table_bytes=2)
    for variant, line, source in (("flat", 469, "sample_frame"),
                                  ("base", 440, "sample_frame"),
                                  ("fuse", 501, "sample_frame_opt"),
                                  ("opt", 501, "sample_frame_opt")):
        ms = {(p, b): bf16_ms[(variant, p, b)]
              for p, b in (("T", big), ("L", 1), ("L", edge))}
        kernels.append({
            "name": f"sample_frame_{variant}_bf16", "route": "cuda",
            "source": f"lpcnet_tpu_torch/csrc/{source}.cu",
            "replaces": f"lpcnet_tpu/kernels/sample_pallas.py:{line}",
            "launches": (codec_runs[(big, "bf16")] if variant == "flat"
                         else bf16_runs[variant]),
            "max_abs_err": bf16_gates[variant]["max_abs_err"],
            "tolerance": "pcm, exc, rng and GRU states exact (plain loop on "
                         "the bf16 tables; float32 instance on them widened)",
            "ms": ms[("T", big)][0], "ms_f32": ms[("T", big)][1],
            "plain_ms": bf16_gates[variant]["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "batch": big, "ms_b1": ms[("L", 1)][0],
            "ms_f32_b1": ms[("L", 1)][1],
            "ms_boundary": ms[("L", edge)][0],
            "ms_f32_boundary": ms[("L", edge)][1],
            "bound_ms_b1": sample_bound_ms(1, FS, False, table_bytes=2)[0]})
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
            row.update(launches_noncausal=nc_counts[big]["tf_flat"],
                       launches_strict=strict_runs[big],
                       launches_strict_b1=strict_runs[1],
                       launches_streaming=mode_counts["streaming"],
                       launches_teacher=mode_counts["teacher"],
                       launches_dred_plc=dred_plc[big]["launches"],
                       launches_dred_plc_b1=dred_plc[1]["launches"],
                       **bench_runs["plc"],
                       strict_step_ms=strict_ms[big],
                       strict_step_ms_b1=strict_ms[1],
                       launches_b1=plc_runs[("flat", 1)],
                       ms_b1=ktime[("tf_flat", 1)],
                       bound_ms_b1=sample_bound_ms(1, FS, True)[0])
        row.update(plan_keys("tf_" + variant))
        row.setdefault("ms_b1", None)
        kernels.append(row)
    bound, bound_by = teacher_bound_ms(big, FS)
    hs = held["teacher"]
    kernels.append({
        "name": "teacher_advance", "route": "cuda",
        "source": "lpcnet_tpu_torch/csrc/teacher_advance.cu",
        "replaces": "lpcnet_tpu/kernels/sample_pallas.py:610",
        "launches": nc_counts[big]["teacher"],
        "max_abs_err": max(h["max_abs_err"] for h in hs),
        "tolerance": "every state field exact (plain and forced K3)",
        "ms": ktime[("teacher", big)],
        "plain_ms": max(h["plain_ms"] for h in hs if h["batch"] == big),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "batch": big, "launches_b1": nc_counts[1]["teacher"],
        "ms_b1": ktime[("teacher", 1)],
        "bound_ms_b1": teacher_bound_ms(1, FS)[0],
        "noncausal_step_ms": nc_step_ms[big],
        "noncausal_step_ms_b1": nc_step_ms[1], **plan_keys("teacher")})
    big_b = BURG_BATCHES[-1]
    kernels.append({
        "name": "burg_cepstrum", "route": "cuda",
        "source": "lpcnet_tpu_torch/csrc/burg_cepstrum.cu",
        "replaces": None, "launches": burg_runs[("flat", big)],
        "launches_b1": burg_runs[("flat", 1)],
        "launches_base": burg_runs[("base", big)],
        "max_abs_err": max(burg_ms[b]["max_abs_err"] for b in BURG_BATCHES),
        "tolerance": f"{BURG_TOL} absolute (plain version on the card)",
        "ms": burg_ms[big_b]["ms"], "plain_ms": burg_ms[big_b]["plain_ms"],
        "bound_ms": burg_ms[big_b]["bound_ms"],
        "bound_by": burg_ms[big_b]["bound_by"],
        "roofline_ms": burg_ms[big_b]["roofline_ms"],
        "roofline_by": burg_ms[big_b]["roofline_by"], "library_ms": None,
        "batch": big_b, "ms_b1": burg_ms[1]["ms"],
        "plain_ms_b1": burg_ms[1]["plain_ms"],
        "bound_ms_b1": burg_ms[1]["bound_ms"],
        "roofline_ms_b1": burg_ms[1]["roofline_ms"]})
    big_l = int(np.prod(LPC_SHAPES[-1]))
    kernels.append({
        "name": "lpc_levinson", "route": "cuda",
        "source": "lpcnet_tpu_torch/csrc/lpc_levinson.cu",
        "replaces": None, "launches": lpc_runs[("flat", big)],
        "launches_b1": lpc_runs[("flat", 1)],
        "launches_base": lpc_runs[("base", big)],
        "rows_held": sum(lpc_rows.values()), "max_abs_err": 0.0,
        "tolerance": "bit-identical to the plain version on the card",
        "ms": lpc_ms[big_l]["ms"], "path_ms": lpc_ms[big_l]["path_ms"],
        "plain_ms": lpc_ms[big_l]["plain_ms"],
        "bound_ms": lpc_ms[big_l]["bound_ms"],
        "bound_by": lpc_ms[big_l]["bound_by"],
        "roofline_ms": lpc_ms[big_l]["roofline_ms"],
        "roofline_by": lpc_ms[big_l]["roofline_by"], "library_ms": None,
        "batch": big_l, "ms_b1": lpc_ms[1]["ms"],
        "path_ms_b1": lpc_ms[1]["path_ms"],
        "plain_ms_b1": lpc_ms[1]["plain_ms"],
        "bound_ms_b1": lpc_ms[1]["bound_ms"],
        "roofline_ms_b1": lpc_ms[1]["roofline_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# float32 operations of Burg's cepstral analysis per half-frame, what the
# function needs (a multiply-add is two): pre-emphasis 79 x 2; the 17
# correlations, 79 + sum(79 - k, k = 1..16) multiply-adds; the 16 steps of
# the recursion (src/burg.c), 14 n + 6 multiply-adds and 6 more operations
# at step n; the residual energy; the impulse's 16 products; the direct
# DFT of the 17 taps into 160 bins and 1 / (|X / 320|^2 + 1e-9), 7 more
# a bin; log10(1e-2 + E), the follower and the 18 x 18 DCT. The band fold
# counts at the band weights that are not zero (burg_flops): each bin
# feeds at most two bands.
BURG_HALF_FLOPS = (2 * 79 + 2 * (79 + sum(79 - k for k in range(1, 17)))
                   + sum(28 * n + 18 for n in range(16)) + 68 + 16
                   + 160 * (2 * 2 * 17 + 7) + 2 * 18 + 5 * 18
                   + 2 * 18 * 18 + 19)
# bytes of a frame in and out, and of the tables, read once a launch
BURG_BYTES, BURG_TABLE_BYTES = 4 * (160 + 36), 4 * (16 + 640 + 2880 + 18 + 324)
# The bound that binds: the dependent chain of one half-frame's warp,
# ~6,800 cycles (FP32 operations 4 cycles, shuffles ~25; ~4,500 of them the
# 16-step recursion) at the H100's 1.98 GHz. Every frame's CTA runs at once
# up to ~4,000 frames, so it holds at B=1 and at B=1024 alike.
BURG_LATENCY_MS = 6800 / 1.98e9 * 1e3


def burg_flops() -> int:
    """float32 operations of one frame: two half-frames, the band fold at
    its nonzero weights (a multiply-add each, then the 18 band scales and
    the gain), then the 36 sums and differences."""
    from lpcnet_tpu_torch.ops.tables import BAND_INTERP
    fold = 2 * int(np.count_nonzero(BAND_INTERP)) + 18 + 2
    return 2 * (BURG_HALF_FLOPS + fold) + 54


def burg_phase(dev, card) -> dict:
    """Phase 3b: ops/burg.burg_cepstral_analysis on the card, kernel
    against plain version at each of BURG_BATCHES frames of the golden
    speech, then the device ms per call of each, replayed from a CUDA
    graph (torch.cuda.graph): the kernel's BURG_REPS launches in one, one
    plain call in another. Returns {batch: {...}}; raises where the
    kernel does not launch once a call or leaves BURG_TOL."""
    import torch
    from lpcnet_tpu_torch.kernels import burg_cuda
    from lpcnet_tpu_torch.ops import burg
    out = {}
    for B in BURG_BATCHES:
        x = torch.as_tensor(tiled_speech(B, 1), device=dev)
        n0 = burg_cuda.launches
        got = burg.burg_cepstral_analysis(x)
        if burg_cuda.launches != n0 + 1:
            raise RuntimeError(f"burg B={B}: {burg_cuda.launches - n0} "
                               f"kernel launches, expected 1")
        want = burg.burg_cepstral_analysis_plain(x)
        d = float((got - want).abs().max())
        captured = {}
        for name, fn, reps in (
                ("kernel", burg.burg_cepstral_analysis, BURG_REPS),
                ("plain", burg.burg_cepstral_analysis_plain, 1)):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn(x)
            captured[name] = (g, reps)
        ms = {k: cuda_ms(g.replay, 20) / reps
              for k, (g, reps) in captured.items()}
        roof, roof_by = _bound(B * burg_flops(),
                               B * BURG_BYTES + BURG_TABLE_BYTES)
        bound, bound_by = max((roof, roof_by),
                              (BURG_LATENCY_MS, "dependent latency"))
        out[B] = {"max_abs_err": d, "ms": ms["kernel"],
                  "plain_ms": ms["plain"], "bound_ms": bound,
                  "bound_by": bound_by, "roofline_ms": roof,
                  "roofline_by": roof_by}
        print(f"[burg] B={B}: max |kernel - plain| {d:.3g} (tolerance "
              f"{BURG_TOL}); per call, replayed from a graph: kernel "
              f"{ms['kernel'] * 1e3:.2f} us, plain {ms['plain']:.4f} ms; "
              f"bound {bound * 1e3:.4f} us ({bound_by}; the roofline's "
              f"{roof * 1e3:.4f} us, {roof_by}, does not bind) [{card}]")
        if not d <= BURG_TOL:
            raise RuntimeError(f"burg B={B}: the kernel is {d} from the "
                               f"plain version, beyond {BURG_TOL}")
    return out


# float32 operations of the LPC kernel per row, what its part of the
# function needs (a multiply-add is two): the 17 lags' scale, the floor's
# three and the lag window's 16; the 16 Levinson steps, at step i a sum of
# i products plus ac[i+1], the division and its sign, i updates, the
# error's three operations and the exit test
LPC_ROW_FLOPS = 17 + 3 + 16 + sum(2 * i + 1 + 2 + 2 * i + 3 + 1
                                  for i in range(16))
# bytes of a row in (its 17 lags) and out (16 lpc and the error), and of the
# lag window, read once a launch
LPC_BYTES, LPC_TABLE_BYTES = 4 * (17 + 17), 4 * 16
# The bound that binds: the recursion's own dependent chain at the H100's
# 1.98 GHz, ~1,400 cycles (FP32 operations 4 cycles, an IEEE division
# ~40): 16 steps, each a tree of i products, the division, the update and
# the error. Whatever the design, a row cannot finish sooner.
LPC_LATENCY_MS = 1400 / 1.98e9 * 1e3
# phase 3c: leading shapes of a call (one stream's frame; synth-b1024's
# conditioning) and kernel launches in the timed graph
LPC_SHAPES, LPC_REPS = ((1, 1), (1024, 50)), 100


def lpc_differ(cep, lpc, err) -> int:
    """Rows whose lpc or err differ, in any bit, from
    dsp.lpc_from_cepstrum_plain on the same cepstra on the card."""
    from lpcnet_tpu_torch.ops import dsp
    want_lpc, want_err = dsp.lpc_from_cepstrum_plain(cep)
    return int(((lpc != want_lpc).any(-1) | (err != want_err)).sum())


def lpc_phase(dev, card) -> dict:
    """Phase 3c: ops/dsp.lpc_from_cepstrum on the card at each of
    LPC_SHAPES rows of the golden features, bit for bit against the plain
    version; then the device ms per call, each replayed from a CUDA graph:
    the kernel alone (LPC_REPS launches in one graph), the card's path
    (the PyTorch operations up to the inverse FFT and the kernel) and the
    plain version (~427 kernels). Returns {rows: {...}}; raises where the
    kernel does not launch once a call or a row differs."""
    import torch
    from lpcnet_tpu_torch.kernels import lpc_cuda
    from lpcnet_tpu_torch.ops import dsp
    out = {}
    for shape in LPC_SHAPES:
        rows = int(np.prod(shape))
        x = torch.as_tensor(tiled_features(*shape), device=dev)
        n0 = lpc_cuda.launches
        lpc, err = dsp.lpc_from_cepstrum(x)
        if lpc_cuda.launches != n0 + 1:
            raise RuntimeError(f"lpc {shape}: {lpc_cuda.launches - n0} "
                               f"kernel launches, expected 1")
        differ = lpc_differ(x, lpc, err)
        spec = dsp.interp_band_gain(dsp._band_energies(x))
        y = torch.fft.irfft(spec.to(torch.complex64), n=320, dim=-1)
        lag = torch.as_tensor(dsp._LAG, device=dev)
        captured = {}
        for name, fn, reps in (
                ("kernel", lambda: lpc_cuda.lpc_from_lags(y, lag), LPC_REPS),
                ("path", lambda: dsp.lpc_from_cepstrum(x), 1),
                ("plain", lambda: dsp.lpc_from_cepstrum_plain(x), 1)):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
            captured[name] = (g, reps)
        ms = {k: cuda_ms(g.replay, 20) / reps
              for k, (g, reps) in captured.items()}
        roof, roof_by = _bound(rows * LPC_ROW_FLOPS,
                               rows * LPC_BYTES + LPC_TABLE_BYTES)
        bound, bound_by = max((roof, roof_by),
                              (LPC_LATENCY_MS, "dependent latency"))
        out[rows] = {"rows_differ": differ, "ms": ms["kernel"],
                     "path_ms": ms["path"], "plain_ms": ms["plain"],
                     "bound_ms": bound, "bound_by": bound_by,
                     "roofline_ms": roof, "roofline_by": roof_by}
        print(f"[lpc] {shape}: rows that differ from the plain version "
              f"{differ} of {rows}; per call, replayed from a graph: kernel "
              f"{ms['kernel'] * 1e3:.2f} us, the card's path "
              f"{ms['path'] * 1e3:.2f} us, plain {ms['plain']:.4f} ms; "
              f"kernel bound {bound * 1e3:.4f} us ({bound_by}; the roofline "
              f"{roof * 1e3:.4f} us, {roof_by}) [{card}]")
        if differ:
            raise RuntimeError(f"lpc {shape}: {differ} rows differ from "
                               f"the plain version")
    return out


def dred_phase(dev, card) -> dict:
    """Phase 2d: DRED end to end with the shipped cond-256/256 weights, as
    the fec-encode command runs it: superframe features of the golden
    speech (64-frame chunks) -> DREDCodec.encode -> for every packet
    position, quantize_payload and decode (cli.dred_payloads), at B=1 and
    at B=1024 (stream b rotated as in codec_speech). Held against the
    port on the CPU (B=1 and the first DRED_CPU_ROWS streams of B=1024) on
    the card's features: symbols, PVQ states, and the features decoded on
    the CPU from the card's symbols and states; the q0 round trip of the
    shipped-weights test. Returns, per batch, the timings, the speech and
    the decoded payloads. Raises RuntimeError on a failed gate."""
    import torch
    from lpcnet_tpu_torch import cli, convert
    from lpcnet_tpu_torch.dred import DREDCodec, roundtrip
    params, cfg = convert.load_dred(device=dev)
    params_cpu, _ = convert.load_dred(device="cpu")
    dc, dc_cpu = (DREDCodec(params, cfg, device=dev),
                  DREDCodec(params_cpu, cfg, device="cpu"))
    n = dc.dred.num_dframes
    print(f"[dred] shipped RDO-VAE: cond {cfg.cond_size}/{cfg.cond_size2}, "
          f"{cfg.nb_latents} latents, {n}-dframe payloads")
    T = np.fromfile(SPEECH, np.int16).size // (4 * FS) * 4
    out = {}
    for B in DRED_BATCHES:
        speech = codec_speech(B)
        padded = np.stack([cli._pad_to_chunks(x, T) for x in speech])
        feats = cli.superframe_features(torch.as_tensor(padded, device=dev),
                                        T)[..., :20]
        dc.encode(feats[:, :16])                                     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zd, sd = dc.encode(feats)
        t_enc_issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        cli.dred_payloads(dc, zd[:, :n], sd[:, :n])                  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payloads = cli.dred_payloads(dc, zd, sd)
        t_pay_issue = (time.perf_counter() - t0) / len(payloads)
        torch.cuda.synchronize()
        t_pay = (time.perf_counter() - t0) / len(payloads)
        print(f"[dred] B={B}: encode {t_enc * 1e3:.4f} ms for the file "
              f"({T} frames, {T * 0.01:.2f} s of audio per stream), "
              f"{t_enc * 1e3 / (T * 0.01):.4f} ms per audio second; "
              f"quantize_payload + decode {t_pay * 1e3:.4f} ms per payload "
              f"of all {B} streams ({len(payloads)} payloads; host clock, "
              f"synchronised); the host issues for "
              f"{t_enc_issue * 1e3:.4f} and {t_pay_issue * 1e3:.4f} ms of "
              f"them before it waits [{card}]")
        rows = list(range(min(B, DRED_CPU_ROWS)))
        zc, sc = dc_cpu.encode(feats[rows].cpu())
        same_state = float((sd[rows].cpu() == sc).all(-1).float().mean())
        syms_k, syms_c, derr = [], [], 0.0
        for s, sym, qid, rec in payloads:
            sym_c, _ = dc_cpu.quantize_payload(zc[:, :s])
            syms_k.append(sym[rows].cpu())
            syms_c.append(sym_c)
            rec_c = dc_cpu.decode(sym[rows].cpu(), qid.cpu(),
                                  sd[rows, s - n].cpu())
            derr = max(derr, float((rec[rows].cpu() - rec_c).abs().max()))
        sk, sc_ = torch.stack(syms_k), torch.stack(syms_c)
        frac = float((sk == sc_).float().mean())
        worst = int((sk - sc_).abs().max())
        print(f"[dred] B={B} vs the CPU on streams {rows}: symbols equal "
              f"{frac:.6f} (gate >= {DRED_GATE_SYMBOLS}), max |d| {worst} "
              f"(gate <= 1); PVQ states equal on {same_state:.6f} of the "
              f"dframes (gate >= {DRED_GATE_STATES}); features decoded from "
              f"the same symbols and states max |d| {derr:.3e} (gate <= "
              f"{DRED_GATE_FEATS})")
        if not (frac >= DRED_GATE_SYMBOLS and worst <= 1
                and same_state >= DRED_GATE_STATES
                and derr <= DRED_GATE_FEATS):
            raise RuntimeError(f"dred B={B}: the card disagrees with the CPU")
        if not all(bool(torch.isfinite(r).all()) for *_, r in payloads):
            raise RuntimeError(f"dred B={B}: decoded features not finite")
        out[B] = {"encode_ms": t_enc * 1e3, "payload_ms": t_pay * 1e3,
                  "payloads": payloads, "n": n, "frames": T,
                  "speech": speech}
    f160 = feats[:1, :160]          # stream 0 is the unrotated file
    rms = roundtrip(params, cfg, f160)[0]
    rms_cpu = roundtrip(params_cpu, cfg, f160.cpu())[0]
    print(f"[dred] q0 round trip of 160 frames of stream 0: RMS {rms:.6f} "
          f"on the card, {rms_cpu:.6f} on the CPU (gates: < 0.8, within "
          f"2%)")
    if not (rms < 0.8 and abs(rms - rms_cpu) <= 0.02 * rms_cpu):
        raise RuntimeError("dred: round-trip quality gate failed")
    return out


def dred_fec_features(payloads, n: int, T: int):
    """(B, T, 20) features for every frame t from the newest payload that
    covers it: payload s holds the frames 4(s-n) .. 4s-1, so the newest of
    the positions n .. S is s = min(S, t//4 + n)."""
    import torch
    S = payloads[-1][0]
    rows = []
    for t in range(T):
        s = min(S, t // 4 + n)
        rows.append(payloads[s - n][3][:, t - 4 * (s - n)])
    return torch.stack(rows, dim=1)


def dred_plc_phase(dev, card, dred_out, params, plc_params, zero_counts,
                   expect_plan, expect_lpc) -> dict:
    """Phase 4d: PLCEngine.step over the speech of phase 2d with
    loss_flags, at each batch of dred_out: before each step, every lost
    stream queues (fec_add, the reference's lpcnet_plc_fec_add) the
    features of that frame from the newest DRED payload that covers it.
    Gates: one K3 launch per step and nothing else, under the batch's plan,
    one Burg kernel launch and two LPC kernel launches per step;
    some lost frames concealed from DRED features; good rows equal their
    input. Returns ms per step, launches and FEC frames per batch. Raises
    RuntimeError on a failed gate."""
    import torch
    from lpcnet_tpu_torch import plc
    from lpcnet_tpu_torch.kernels import burg_cuda, sample_cuda
    out = {}
    for B, d in dred_out.items():
        T = d["frames"]
        pcm_in, lost = d["speech"][:, :T * FS], loss_flags(B, T)
        fec = dred_fec_features(d["payloads"], d["n"], T)
        eng = plc.PLCEngine(params, plc_params, device=dev)
        eng.run(eng.init_state(B), pcm_in[:, :2 * FS], lost[:, :2])  # warm
        pcm_t = torch.as_tensor(pcm_in, device=dev)
        lost_t = torch.as_tensor(lost, device=dev)
        consumed = torch.zeros((), dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        zero_counts()
        outs = []
        st = eng.init_state(B)
        t0 = time.perf_counter()
        for t in range(T):
            if lost[:, t].any():
                st = eng.fec_add(st, fec[:, t], lost_t[:, t])
            st, o = eng.step(st, pcm_t[:, t * FS:(t + 1) * FS], lost_t[:, t])
            # a lost frame that took a queued FEC frame resets the loss
            # count (lpcnet_plc.c:147-166)
            consumed += (lost_t[:, t] & (st["loss_count"] == 0)).sum()
            outs.append(o)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sample_cuda.launches)
        o = torch.cat(outs, dim=1).cpu().numpy()
        n_fec = int(consumed)
        tag = f"DRED -> PLCEngine B={B}"
        blend = np.concatenate([np.zeros((B, 1), bool), lost[:, :-1]], 1) \
            & ~lost
        good = np.repeat(~lost & ~blend, FS, axis=1)
        good_ok = bool((o[good] == pcm_in[good]).all())
        print(f"[dred-plc] {tag} x {T} frames: launches {counts}, Burg "
              f"{burg_cuda.launches}; lost "
              f"{int(lost.sum())} frames, {n_fec} of them concealed from "
              f"DRED features (gate > 0); out finite "
              f"{bool(np.isfinite(o).all())}, max |out| {np.abs(o).max()}, "
              f"good rows equal input {good_ok}; {wall * 1e3 / T:.4f} ms per "
              f"step with the queueing (host clock, synchronised at the "
              f"end) [{card}]")
        if counts["tf_flat"] != T or sum(counts.values()) != T:
            raise RuntimeError(f"{tag}: expected {T} tf_flat launches and "
                               f"nothing else, got {counts}")
        if burg_cuda.launches != T:
            raise RuntimeError(f"{tag}: expected {T} Burg kernel launches "
                               f"(one a step), got {burg_cuda.launches}")
        expect_lpc(tag, 2 * T)
        expect_plan(tag, B, T)
        if not (n_fec > 0 and good_ok and np.isfinite(o).all()
                and np.abs(o).max() <= 32767):
            raise RuntimeError(f"{tag}: no FEC frame was used, or the "
                               f"output is wrong")
        out[B] = {"ms": wall * 1e3 / T, "launches": counts["tf_flat"],
                  "fec_frames": n_fec}
    return out


def dotprod_phase(dev, card, sample_cuda) -> dict:
    """Phase 4e: Synthesizer(backend="dotprod"), both flavours, B=4 x 2
    frames of the golden features, on the card and on the CPU. The
    emulation runs no hand-written kernel. On the CPU run's tables and
    conditions, moved to the card, it gives the CPU run's pcm, excitation,
    RNG and GRU states exactly; the card's own run has the CPU run's RNG.
    Returns ms per frame per flavour. Raises RuntimeError on a failed
    gate."""
    import torch
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.kernels import sample_dotprod
    from lpcnet_tpu_torch.vocoder import Synthesizer
    B, frames = DOTPROD_PATH
    feats = tiled_features(B, frames)
    keys = ("cond_a", "cond_b", "lpc")
    params, params_cpu = (convert.load_lpcnet(device=dev),
                          convert.load_lpcnet(device="cpu"))
    out = {}
    for su in (False, True):
        tag = f"dotprod {'SU' if su else 'signed'} B={B}"
        v = Synthesizer(params=params, device=dev, backend="dotprod",
                        dotprod_su=su)
        vc = Synthesizer(params=params_cpu, device="cpu", backend="dotprod",
                         dotprod_su=su)
        v.synthesize(v.reset(B, True), feats[:, :1])                 # warm
        torch.cuda.synchronize()
        for k in sample_cuda.launches:
            sample_cuda.launches[k] = 0
        t0 = time.perf_counter()
        st, pcm = v.synthesize(v.reset(B, True), feats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / frames
        launched = sum(sample_cuda.launches.values())
        t0 = time.perf_counter()
        st_c, pcm_c = vc.synthesize(vc.reset(B, True), feats)
        ms_cpu = (time.perf_counter() - t0) * 1e3 / frames
        conds_c = vc.conditions(feats)
        cond_err = max(float((v.conditions(feats)[k].cpu() - conds_c[k])
                             .abs().max()) for k in keys)
        tables = convert.to_device(vc.tables, dev)
        st_h, pcm_h = sample_dotprod.synthesize_frames_dotprod(
            tables, sample_dotprod.quantize_tables(tables, v.cfg, su),
            {k: x.to(dev) for k, x in vc.reset(B, True).items()},
            {k: conds_c[k].to(dev) for k in keys}, v.cfg)
        same = {k: torch.equal(st_h[k].cpu(), st_c[k])
                for k in ("last_exc", "rng", "gru_a", "gru_b")}
        same["pcm"] = torch.equal(pcm_h.cpu(), pcm_c)
        rng_ok = torch.equal(st["rng"].cpu(), st_c["rng"])
        p = pcm.cpu().numpy()
        frac = float((pcm.cpu() == pcm_c).float().mean())
        print(f"[dotprod] {tag} x {frames} frames: hand-written kernel "
              f"launches {launched}; on the CPU run's tables and conditions "
              f"the card equals the CPU run {same}; the card's own run: rng "
              f"equal to the CPU run's {rng_ok}, pcm equal on {frac:.6f} "
              f"(its conditions differ from the CPU's by {cond_err:.3e}, "
              f"which the activation quantizer can turn into a fork), "
              f"finite {bool(np.isfinite(p).all())}, max |pcm| "
              f"{np.abs(p).max()}; {ms:.4f} ms per frame on the card, "
              f"{ms_cpu:.4f} on the CPU (host clock) [{card}]")
        if launched or not (all(same.values()) and rng_ok
                            and np.isfinite(p).all()
                            and 0 < np.abs(p).max() <= 32767):
            raise RuntimeError(f"{tag}: the emulation on the card is not "
                               f"the CPU run's")
        out[su] = {"ms": ms, "ms_cpu": ms_cpu, "pcm_equal": frac}
    return out


def tools_phase(card) -> dict:
    """Phase 4f: the commands rdovae-encode, rdovae-decode, fec-encode,
    plc-test and addlpc through cli.main in a temporary directory, on the
    card and with --device cpu, each pair held to the tolerances of
    tests/test_torch_tools.py; dump-weights-blob (numpy, no device) read
    back record by record and written twice, byte-identical. Returns the
    seconds of each run. Raises RuntimeError on a failed gate."""
    import tempfile
    from lpcnet_tpu_torch import cli, convert
    from lpcnet_tpu_torch.utils import fec_packets, weights_io
    examples = os.path.join(REPO, "examples")
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        def both(cmd, args):
            """The command on the card and on the CPU: (card out, cpu out)."""
            outs = []
            for i, dev in enumerate(("cuda", "cpu")):
                out = path(f"{cmd}.{i}")
                t0 = time.perf_counter()
                rc = cli.main([cmd] + [out if a == "OUT" else a
                                       for a in args] + ["--device", dev])
                secs[(cmd, i)] = time.perf_counter() - t0
                if rc != 0:
                    raise RuntimeError(f"tools: {cmd} --device {dev} exit "
                                       f"{rc}")
                outs.append(out)
            return outs

        def check(cmd, ok, detail):
            print(f"[tools] {cmd}: card vs --device cpu {detail}; "
                  f"{secs[(cmd, 0)]:.3f} s on the card, "
                  f"{secs[(cmd, 1)]:.3f} s on the CPU (host clock, "
                  f"whole command) [{card}]")
            if not ok:
                raise RuntimeError(f"tools: {cmd} differs between the card "
                                   f"and the CPU")

        f40 = path("f40.f32")
        np.fromfile(FEATS, np.float32)[:40 * 36].tofile(f40)
        k, c = both("rdovae-encode", [f40, "OUT", "--quant", "7"])
        sk, sc = np.fromfile(k, np.int16), np.fromfile(c, np.int16)
        st_err = float(np.abs(np.fromfile(k + ".state", np.float32)
                              - np.fromfile(c + ".state", np.float32)).max())
        frac = float((sk == sc).mean())
        worst = int(np.abs(sk.astype(np.int32) - sc).max())
        check("rdovae-encode", frac >= DRED_GATE_SYMBOLS and worst <= 1
              and st_err <= 1e-5, f"symbols equal {frac:.6f}, max |d| "
              f"{worst}; states max |d| {st_err:.3e} (gates >= "
              f"{DRED_GATE_SYMBOLS}, <= 1, <= 1e-5)")
        k, c = both("rdovae-decode", [c, "OUT"])
        err = float(np.abs(np.fromfile(k, np.float32)
                           - np.fromfile(c, np.float32)).max())
        check("rdovae-decode", err <= 1e-4, f"from the CPU's latent file: "
              f"max |d| {err:.3e} (gate <= 1e-4)")
        pcm80 = path("in.s16")
        np.fromfile(SPEECH, np.int16)[:80 * FS].tofile(pcm80)
        k, c = both("fec-encode", [pcm80, "OUT", "--num-redundancy", "8",
                                   "--packets-per-fec", "2"])
        (pk, rates_k), (pc, rates_c) = (fec_packets.read_fec_packets(k),
                                        fec_packets.read_fec_packets(c))
        with open(k, "rb") as a, open(c, "rb") as b:
            same_head = a.read(14) == b.read(14)
        err = max(float(np.abs(x - y).max()) for x, y in zip(pk, pc))
        rates_ok = np.allclose(rates_k, rates_c, rtol=0.01, atol=0)
        check("fec-encode", same_head and len(pk) == len(pc) > 0
              and err <= 1e-3 and rates_ok,
              f"header identical {same_head}, {len(pk)} / {len(pc)} "
              f"packets, features max |d| {err:.3e} (gate <= 1e-3), rates "
              f"{rates_k} / {rates_c} (gate: within 1%)")
        rs = np.random.RandomState(11)
        data = rs.randn(50, 57).astype(np.float32)
        data[:, -1] = (rs.random_sample(50) > 0.3).astype(np.float32)
        data.tofile(path("plc.f32"))
        k, c = both("plc-test", [path("plc.f32"), "OUT"])
        err = float(np.abs(np.fromfile(k, np.float32)
                           - np.fromfile(c, np.float32)).max())
        check("plc-test", err <= 1e-5, f"max |d| {err:.3e} (gate <= 1e-5)")
        feats = np.fromfile(FEATS, np.float32).reshape(-1, 36).copy()
        feats[:, 20:] = 0
        feats.tofile(path("lpc.f32"))
        k, c = both("addlpc", [path("lpc.f32"), "OUT"])
        a, b = np.fromfile(k, np.float32), np.fromfile(c, np.float32)
        err = float(np.abs(a - b).max())
        check("addlpc", bool(np.all(np.abs(a - b) <= 1e-4 + 1e-4
                                    * np.abs(b))),
              f"max |d| {err:.3e} (gate: 1e-4 + 1e-4 |x|)")
        specs = [f"{m}={os.path.join(examples, f'speech_{m}_params.bin')}"
                 for m in ("plc", "lpcnet")]
        blobs = []
        for i in range(2):
            blobs.append(path(f"blob{i}.bin"))
            t0 = time.perf_counter()
            if cli.main(["dump-weights-blob", blobs[-1]] + specs) != 0:
                raise RuntimeError("tools: dump-weights-blob failed")
            secs[("dump-weights-blob", i)] = time.perf_counter() - t0
        with open(blobs[0], "rb") as a, open(blobs[1], "rb") as b:
            same = a.read() == b.read()
        raw = weights_io.read_blob(blobs[0])
        want = {}
        for spec in specs:
            prefix, p = spec.split("=", 1)
            flat = weights_io.flatten(convert.load_model_params(p),
                                      prefix + "/")
            want.update({f"{prefix[0]}{j:04d}": a.reshape(-1)
                         for j, (_, a) in enumerate(sorted(flat.items()))})
        back = raw.keys() == want.keys() and all(
            np.array_equal(raw[r], want[r]) for r in want)
        print(f"[tools] dump-weights-blob (numpy, no device): {len(raw)} "
              f"records, read back equal to the checkpoints' arrays {back}, "
              f"two runs byte-identical {same}; "
              f"{secs[('dump-weights-blob', 0)]:.3f} s [{card}]")
        if not (same and back):
            raise RuntimeError("tools: dump-weights-blob is not the "
                               "checkpoints' arrays")
    return secs


def train_phase(dev, card) -> None:
    """Phase 4g: training end to end on the card (no hand-written kernel
    runs on this path: the recurrences are autograd over eager PyTorch).
    The corpus: dump-data train on the golden speech, TRAIN_PASSES
    augmentation passes as one batched feature stream, on the card and
    with --device cpu (features within 1e-4, sig_out exact, sig_in held
    by SIG_IN_EQUAL and SIG_IN_RMS), and dump-data btrain for PLC. train-lpcnet at
    LPCNetConfig(): one noise-free step on the card against the same step
    on the host's CPU at B=4 (loss relative 1e-5, every gradient leaf
    within 1e-4 of its largest entry). Each trainer's train_step (LPCNet
    on one batch of 32 with the loss falling, PLC, RDO-VAE) eager and
    graphed (graphed_against_eager: eager and replayed ms, capture s,
    graph nodes, peak memory; the graphed steps bit-identical to the
    eager ones). train-lpcnet for 2 epochs of 3 steps (one capture, 5
    replays) and a --resume of its last checkpoint (the parameters
    restored bit for bit, the step count continued); train-plc,
    train-rdovae and vq-train at the shipped sizes through their
    commands. Raises RuntimeError on a failed gate."""
    import tempfile
    import torch
    from lpcnet_tpu_torch import cli, convert
    from lpcnet_tpu_torch import data as D
    from lpcnet_tpu_torch.models import lpcnet as lpcnet_model
    from lpcnet_tpu_torch.models import plc as plc_model
    from lpcnet_tpu_torch.models import rdovae as rv
    from lpcnet_tpu_torch.training import (lpcnet_task, optim, plc_task,
                                           rdovae_task)
    from lpcnet_tpu_torch.utils import checkpoint, graphs, native
    card_dev = str(dev)

    def line(msg):
        print(f"[train] {msg} [{card}]")

    def run(argv):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"train: {' '.join(argv[:2])} exit {rc}")
        return time.perf_counter() - t0

    def graphed_against_eager(tag, jit, make, n, samples):
        """The trainer's train_step (jit) from a fresh run (make() ->
        params, optimizer state, a function of (params, state) giving a
        step's arguments, the generator): TRAIN_HELD steps eagerly
        (graphs.disabled()) and n steps graphed, the first eager, the
        second captured and replayed, the others replays. The graphed
        run's first TRAIN_HELD steps (params, Adam state and metrics, and
        the generator's state after them) must be the eager run's bit for
        bit. Prints the eager and replayed ms per step, `samples` (a count
        and its unit) per s of each, the capture's s, the graph's nodes
        (the capture keeps its cudaGraph_t), the peak memory allocated
        over what was allocated at the start of an eager step, of the
        capturing step and of a replay, and the memory reserved over the
        capturing step. Returns the graphed run's losses."""
        def run(n_steps, graphed, timed_from):
            p, st, args, gen = make()
            outs, ms, mem, losses, gen_at = [], [], {}, [], None
            with contextlib.nullcontext() if graphed else graphs.disabled():
                for k in range(n_steps):
                    if graphed and k == 1:
                        # the capture empties the cache itself; emptied
                        # here, the growth of the reserved memory over
                        # the capturing step is the graph's pool
                        torch.cuda.empty_cache()
                    torch.cuda.synchronize(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    held = torch.cuda.memory_allocated(dev)
                    reserved = torch.cuda.memory_reserved(dev)
                    t0 = time.perf_counter()
                    p, st, m = jit(*args(p, st))
                    torch.cuda.synchronize(dev)
                    if k >= timed_from:
                        ms.append((time.perf_counter() - t0) * 1e3)
                    mem[k] = (torch.cuda.max_memory_allocated(dev) - held,
                              torch.cuda.memory_reserved(dev) - reserved)
                    losses.append(float(m["loss"]))
                    if k < TRAIN_HELD:
                        outs.append((p, st, m))
                    if k == TRAIN_HELD - 1:
                        gen_at = gen.get_state()
            return outs, ms, mem, losses, gen_at

        jit.clear()
        graphs.captures.clear()
        graphs.replays.clear()
        eager, e_ms, e_mem, _, e_gen = run(TRAIN_HELD, False, 1)
        # the jit's capture keeps its cudaGraph_t, for the node count
        capture = graphs.compile_step
        graphs.compile_step = functools.partial(capture, keep_graph=True)
        try:
            graphed, g_ms, g_mem, losses, g_gen = run(n, True, 2)
        finally:
            graphs.compile_step = capture
        (step,) = jit.steps.values()
        nodes = graphs.graph_nodes(step.graph)
        counts = (graphs.captures[jit.name], graphs.replays[jit.name])
        same = (all(_same_tree(a, b) for a, b in zip(eager, graphed))
                and torch.equal(e_gen, g_gen))
        jit.clear()
        eager_ms, replay_ms = float(np.mean(e_ms)), float(np.mean(g_ms))
        n_s, unit = samples
        gib = 2.0 ** 30
        line(f"{tag}: eager {eager_ms:.1f} ms per step "
             f"({n_s / eager_ms * 1e3:.0f} {unit} per s, mean of "
             f"{len(e_ms)} after a warm-up step), replayed {replay_ms:.1f} "
             f"({n_s / replay_ms * 1e3:.0f} {unit} per s, mean of "
             f"{len(g_ms)}; {eager_ms / replay_ms:.2f}x); capture "
             f"{step.capture_s:.2f} s (instantiation included), {nodes} "
             f"graph nodes; {counts[0]} capture and {counts[1]} replays in "
             f"{n} steps; peak memory allocated over the step's start: "
             f"eager step {e_mem[1][0] / gib:.2f} GiB, capturing step "
             f"{g_mem[1][0] / gib:.2f}, replay {g_mem[n - 1][0] / gib:.2f}; "
             f"reserved over the capturing step {g_mem[1][1] / gib:+.2f} "
             f"GiB (the graph's pool)")
        line(f"{tag}: {TRAIN_HELD} graphed steps (eager, captured, replayed) "
             f"against {TRAIN_HELD} eager from the same parameters, Adam "
             f"state, inputs and generator seed: params, moments, counts, "
             f"metrics and the generator's state bit-identical {same}; "
             f"graphed losses {losses}")
        if not same:
            raise RuntimeError(f"train: {tag}: the graphed steps are not "
                               f"the eager ones")
        if counts != (1, n - 1):
            raise RuntimeError(f"train: {tag}: {counts} captures and "
                               f"replays in {n} steps")
        return losses

    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        # ---- the corpus, on the card and on the CPU
        secs = [run(["dump-data", "train", SPEECH, path(f"f{i}.f32"),
                     path(f"d{i}.s16"), "--passes", str(TRAIN_PASSES),
                     "--batch-passes", str(TRAIN_PASSES), "--device", dv])
                for i, dv in enumerate((card_dev, "cpu"))]
        lib = native.SHIPPED if native.NATIVE.how == "loaded" \
            else native.BUILT
        line(f"native library {native.NATIVE.how}: {lib}")
        feats = cli.read_features(path("f0.f32"))
        data = np.fromfile(path("d0.s16"), np.int16).reshape(-1, 2)
        f_cpu = cli.read_features(path("f1.f32"))
        d_cpu = np.fromfile(path("d1.s16"), np.int16).reshape(-1, 2)
        ferr = float(np.abs(feats - f_cpu).max())
        same_out = bool(np.array_equal(data[:, 1], d_cpu[:, 1]))
        d = np.abs(data[:, 0].astype(np.int64) - d_cpu[:, 0])
        sig_in = float((d == 0).mean())
        rms = float(np.sqrt((d ** 2.0).mean()
                            / (d_cpu[:, 0] ** 2.0).mean()))
        line(f"dump-data train, {TRAIN_PASSES} passes batched: "
             f"{feats.shape[0]} frames; {secs[0] / TRAIN_PASSES:.3f} s per "
             f"pass on the card, {secs[1] / TRAIN_PASSES:.3f} on the CPU "
             f"(host clock, whole command); card vs CPU: features max |d| "
             f"{ferr:.3e} (gate 1e-4), sig_out equal {same_out}, sig_in "
             f"equal {sig_in:.6f} (gate >= {SIG_IN_EQUAL}), within 1 "
             f"{float((d <= 1).mean()):.6f}, max |d| {int(d.max())}, RMS "
             f"of the difference {rms:.2e} of the signal's (gate <= "
             f"{SIG_IN_RMS})")
        if not (ferr <= 1e-4 and same_out and sig_in >= SIG_IN_EQUAL
                and rms <= SIG_IN_RMS):
            raise RuntimeError("train: the card's corpus is not the CPU's")
        sec = run(["dump-data", "btrain", SPEECH, path("b.f32"),
                   path("b.s16"), "--passes", str(PLC_PASSES), "--seed",
                   "100", "--device", card_dev])
        line(f"dump-data btrain, {PLC_PASSES} passes: {sec / PLC_PASSES:.3f} "
             f"s per pass on the card")

        # ---- train-lpcnet at full width: one step, card against CPU
        cfg = lpcnet_model.LPCNetConfig()
        init = lpcnet_model.init_params(torch.Generator().manual_seed(0),
                                        cfg)
        batches = D.window_batches(feats, data, batch_size=TRAIN_BATCH,
                                   rng=np.random.RandomState(0))
        big = next(batches)
        small = {k: v[:4] for k, v in big.items()}
        grads = {}
        for dv in (card_dev, "cpu"):
            (loss, _), g = optim.value_and_grad(
                lambda p: lpcnet_task.loss_fn(
                    p, {k: torch.as_tensor(v, device=dv)
                        for k, v in small.items()}, cfg),
                convert.to_device(init, dv))
            grads[dv] = (float(loss), [x.cpu().numpy()
                                       for x in optim.tree_leaves(g)])
        rel = abs(grads[card_dev][0] / grads["cpu"][0] - 1)
        worst = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                    for a, b in zip(grads[card_dev][1], grads["cpu"][1]))
        line(f"train-lpcnet LPCNetConfig() one noise-free step at B=4 x "
             f"{small['sig_in'].shape[1]}: loss card {grads[card_dev][0]:.7f} "
             f"CPU {grads['cpu'][0]:.7f} (relative {rel:.2e}, gate 1e-5); "
             f"worst gradient leaf max|d| / max|g| {worst:.2e} (gate 1e-4)")
        if not (rel <= 1e-5 and worst <= 1e-4):
            raise RuntimeError("train: the card's gradients are not the "
                               "CPU's")

        # ---- the train step at 32 x 2400, graphed against eager
        opt = lpcnet_task.make_optimizer()
        tb = {k: torch.as_tensor(v, device=dev) for k, v in big.items()}
        S = big["sig_in"].shape[1]

        def lpc_run():
            gen = torch.Generator(device=dev).manual_seed(1)
            p = convert.to_device(init, dev)
            return (p, opt.init(p),
                    lambda p, s: (p, s, tb, cfg, opt, gen), gen)

        losses = graphed_against_eager(
            f"train-lpcnet LPCNetConfig() {TRAIN_BATCH} x {S}",
            lpcnet_task.train_step, lpc_run, TRAIN_STEPS,
            (TRAIN_BATCH * S, "training samples"))
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"train: the loss did not fall: {losses}")

        # ---- the command: 2 epochs of 3 steps, then --resume
        run_dir = path("lpcnet")
        argv = ["train-lpcnet", path("f0.f32"), path("d0.s16"), run_dir,
                "--device", card_dev]
        name = lpcnet_task.train_step.name
        graphs.captures.clear()
        graphs.replays.clear()
        sec = run(argv + ["--epochs", "2", "--steps-per-epoch", "3"])
        counts = (graphs.captures[name], graphs.replays[name])
        lpcnet_task.train_step.clear()
        ck = os.path.join(run_dir, "ckpt_001.bin")
        tree, leaves, step, _ = checkpoint.load_training(ck)
        args = cli.build_parser().parse_args(argv + ["--resume", ck])
        params, state, step0, epoch0 = cli._start(args, opt, None, dev)
        exact = all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(
            optim.tree_leaves(params), optim.tree_leaves(tree)))
        run(argv + ["--resume", ck, "--epochs", "1", "--steps-per-epoch",
                    "1"])
        step2 = checkpoint.load_training(
            os.path.join(run_dir, "ckpt_002.bin"))[2]
        line(f"train-lpcnet --epochs 2 --steps-per-epoch 3: {sec:.1f} s, "
             f"{counts[0]} capture and {counts[1]} replays of {name}; "
             f"--resume: parameters restored bit for bit {exact}, step "
             f"{step0} (saved {step}), optimizer counts "
             f"{int(state['count'])}/{int(state['sched_count'])}, epoch "
             f"{epoch0}; one more step -> step {step2}")
        if not (exact and step0 == step == 6 and int(state["count"]) == 6
                and int(state["sched_count"]) == 6 and epoch0 == 2
                and step2 == 7 and counts == (1, 5)):
            raise RuntimeError("train: train-lpcnet --resume is not exact "
                               "or the command's steps were not replayed")

        # ---- train-plc at PLCConfig(), seq-len and batch cut to the corpus
        pcfg = plc_model.PLCConfig()
        raw = np.fromfile(path("b.f32"), np.float32).reshape(-1, 72)[:, :56]
        T, B = PLC_SEQ, PLC_BATCH
        pf = torch.as_tensor(raw[:B * T].reshape(B, T, 56), device=dev)
        lost = torch.as_tensor(
            np.random.RandomState(0).uniform(size=(B, T)) > 0.2, device=dev)
        popt = plc_task.make_optimizer()
        pinit = plc_model.init_params(torch.Generator().manual_seed(0), pcfg)

        def plc_run():
            gen = torch.Generator(device=dev).manual_seed(1)
            p = convert.to_device(pinit, dev)
            return (p, popt.init(p),
                    lambda p, s: (p, s, plc_task.make_batch(gen, pf, lost),
                                  pcfg, popt), gen)

        graphed_against_eager(f"train-plc PLCConfig() {B} x {T}",
                              plc_task.train_step, plc_run, PLC_STEPS,
                              (B * T, "training frames"))
        sec = run(["train-plc", path("b.f32"), path("plc"), "--seq-len",
                   str(T), "--batch-size", str(B), "--epochs", "1",
                   "--device", card_dev])
        plc_task.train_step.clear()
        line(f"train-plc PLCConfig(), --seq-len {T} --batch-size {B} (cut "
             f"from 1000 x 32 to fit the {raw.shape[0]}-frame corpus): the "
             f"command, one epoch: {sec:.1f} s")

        # ---- train-rdovae at the command's default 1024/256
        rcfg = rv.RDOVAEConfig()
        T, B = RDOVAE_SEQ, RDOVAE_BATCH
        rf = torch.as_tensor(feats[:B * T, :20].reshape(B, T, 20),
                             device=dev)
        ropt = rdovae_task.make_optimizer()
        rinit = rv.rate_aware_quant_init(
            rv.init_params(torch.Generator().manual_seed(0), rcfg), rcfg)

        def rdovae_run():
            gen = torch.Generator(device=dev).manual_seed(1)
            p = convert.to_device(rinit, dev)

            def args(p, s):
                # the level drawn between steps from the noise generator,
                # as the train-rdovae command draws it
                q, lam = rdovae_task.sample_lambda(gen, B, T // 2,
                                                   device=dev)
                return (p, s, rf, q, lam, gen, rcfg, ropt)

            return p, ropt.init(p), args, gen

        graphed_against_eager(
            f"train-rdovae cond {rcfg.cond_size}/{rcfg.cond_size2} {B} x {T}",
            rdovae_task.train_step, rdovae_run, RDOVAE_STEPS,
            (B * T, "training frames"))
        sec = run(["train-rdovae", path("f0.f32"), path("rdovae"),
                   "--seq-len", str(T), "--batch-size", str(B), "--epochs",
                   "1", "--steps-per-epoch", "1", "--device", card_dev])
        rdovae_task.train_step.clear()
        line(f"train-rdovae cond {rcfg.cond_size}/{rcfg.cond_size2}, "
             f"--seq-len {T} --batch-size {B} (batch cut from 32 to fit "
             f"the corpus): the command, one step: {sec:.1f} s")

        # ---- vq-train at the shipped sizes
        sec = run(["vq-train", path("f0.f32"), path("cb.bin"), "--iters",
                   "1", "--final-iters", "2", "--device", card_dev])
        from lpcnet_tpu_torch.utils import weights_io
        shapes = {k: v.shape for k, v in
                  weights_io.load_params(path("cb.bin")).items()}
        line(f"vq-train --iters 1 --final-iters 2 on {feats.shape[0]} "
             f"frames: {sec:.1f} s; codebooks {shapes}")
        if shapes != {"cb1": (1024, 17), "cb2": (1024, 17),
                      "cb3": (1024, 17), "diff4": (4096, 18)}:
            raise RuntimeError(f"train: vq-train gave {shapes}")


def dp_rank(rank, world, device, batch, frames) -> dict:
    """One rank of phase 4h, in a process of its own (parallel/mesh.spawn):
    shard_synthesis of `batch` streams of tiled_features, this rank's
    block, `frames` frames (warmed once; launch counts set to 0 just before
    the timed run and read just after it), the pcm gathered onto rank 0;
    the rank's launches held against the plain loop on its own state and
    first GATE_FRAMES frames of conditions; then train_rank, the rank's
    part of dryrun_training_step. The rank's synthesis runs eagerly
    (graphs.disabled()), as main's phases do: it counts launches per call."""
    import torch
    import torch.distributed as dist
    from lpcnet_tpu_torch.utils import graphs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with graphs.disabled():
        out = _dp_rank(rank, world, device, batch, frames)
    if dist.get_backend() == "nccl":
        out["graph"] = dp_graph_rank(rank, world, device)
    return out


def dp_graph_rank(rank, world, device) -> dict:
    """This rank's dry-run training step (LPCNetConfig(), its rows of a
    batch of 2 x world, DP_TRAIN_FRAMES frames) for DP_GRAPH_STEPS steps
    from the same parameters and noise seed, under graphs.disabled() and
    graphed (mesh.dp_train_step: the first step eager, the second captured
    with both all-reduces inside, the others replays): whether every
    step's parameters, Adam state and metrics and the generator's final
    state are bit-identical, the captures and replays, and the eager and
    replayed ms per step (host clock, synchronised; the median of the
    eager steps after the first and of the replays) and the capture's s."""
    import torch
    from lpcnet_tpu_torch.parallel import mesh
    from lpcnet_tpu_torch.utils import graphs
    cfg, params, opt, _, _ = mesh.dryrun_setup(device)
    params = mesh.replicate(params)
    local = {k: torch.as_tensor(v, device=device) for k, v in
             mesh.shard_batch(mesh.dryrun_batch(2 * world, DP_TRAIN_FRAMES,
                                                cfg), rank, world).items()}

    def run():
        gen = torch.Generator(device=device).manual_seed(1)
        p, st, outs, ms = params, opt.init(params), [], []
        for _ in range(DP_GRAPH_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            p, st, m = mesh.dp_train_step(p, st, local, cfg, opt, gen)
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append((p, st, m))
        return outs, gen.get_state(), ms

    mesh._dp_step.clear()
    with graphs.disabled():
        eager, gen_e, ms_e = run()
    graphs.captures.clear()
    graphs.replays.clear()
    graphed, gen_g, ms_g = run()
    same = torch.equal(gen_e, gen_g) and all(
        _same_tree(e, g) for e, g in zip(eager, graphed))
    out = {"same": same, "captures": dict(graphs.captures),
           "replays": dict(graphs.replays),
           "eager_ms": float(np.median(ms_e[1:])),
           "replay_ms": float(np.median(ms_g[2:])),
           "capture_call_s": ms_g[1] / 1e3,
           "capture_s": next(iter(mesh._dp_step.steps.values())).capture_s,
           "loss": float(graphed[-1][2]["loss"])}
    mesh._dp_step.clear()
    return out


def _dp_rank(rank, world, device, batch, frames) -> dict:
    import torch
    import torch.distributed as dist
    from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
    from lpcnet_tpu_torch.parallel import mesh
    from lpcnet_tpu_torch.vocoder import Synthesizer
    v = Synthesizer(device=device)
    feats = tiled_features(batch, frames)
    state0, synth_fn = mesh.shard_synthesis(v, batch)
    synth_fn(state0, feats)                                   # warm
    torch.cuda.synchronize(device)
    for counts in (sample_cuda.launches, sample_cuda.plan_launches):
        for k in counts:
            counts[k] = 0
    dist.barrier()
    t0 = time.perf_counter()
    _, pcm = synth_fn(state0, feats)
    torch.cuda.synchronize(device)
    synth_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(sample_cuda.launches)
    plan_launches = dict(sample_cuda.plan_launches)
    last_plan = list(sample_cuda.last_plan)
    t0 = time.perf_counter()
    full = mesh.gather_rows(pcm)
    torch.cuda.synchronize(device)
    gather_ms = (time.perf_counter() - t0) * 1e3
    b = batch // world
    conds = v.conditions(feats[rank * b:(rank + 1) * b])
    c = {k: conds[k][:, :GATE_FRAMES].contiguous()
         for k in ("cond_a", "cond_b", "lpc")}
    st_k, pcm_k = sample_cuda.synthesize_frames(v.tables, state0, c, v.cfg)
    st_p, pcm_p = sample_scan.synthesize_frames(v.tables, state0, c, v.cfg,
                                                flat=True)
    hold = {**compare_pcm(pcm_k, pcm_p),
            "rng_exact": torch.equal(st_k["rng"], st_p["rng"]),
            "state_equal": all(torch.equal(st_k[k], st_p[k]) for k in st_p),
            "in_path": torch.equal(pcm[:, :GATE_FRAMES * FS], pcm_k)}
    return {"rows": b, "pcm": None if full is None else full.cpu(),
            "launches": launches, "plan_launches": plan_launches,
            "last_plan": last_plan, "ms_per_frame": synth_ms / frames,
            "gather_ms": gather_ms, "hold": hold,
            "train": mesh.train_rank(rank, world, device, DP_TRAIN_FRAMES)}


def dp_phase(dev, card, params, edge) -> dict:
    """Phase 4h: stream-parallel synthesis and the data-parallel training
    step in two worlds, each rank a spawned process (dp_rank): NCCL over
    every visible card, and gloo with two ranks on cuda:0 (NCCL takes one
    rank per card). Per world: every rank launched K1 once per frame under
    its batch's plan, each launch held against the plain loop; rank 0's
    gathered pcm bit-identical to one Synthesizer at DP_BATCH with
    per-stream seeds, run here; the dry-run step's ranks' parameters equal
    exactly and its loss within 1e-5 (relative) of the single-process step
    on the whole batch, run here. Returns per world its K1 launches and
    largest error against the plain loop; raises RuntimeError on a failed
    gate."""
    import torch
    from lpcnet_tpu_torch.parallel import mesh
    from lpcnet_tpu_torch.training import lpcnet_task, optim
    from lpcnet_tpu_torch.vocoder import Synthesizer
    voc = Synthesizer(params=params, device=dev)
    feats = tiled_features(DP_BATCH, DP_FRAMES)
    st0 = voc.reset(DP_BATCH, per_stream_rng=True)
    voc.synthesize(st0, feats)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ref = voc.synthesize(st0, feats)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3 / DP_FRAMES
    ref = ref.cpu()
    n = torch.cuda.device_count()
    out, single = {}, {}
    for backend, devices in (("nccl", [f"cuda:{r}" for r in range(n)]),
                             ("gloo", ["cuda:0", "cuda:0"])):
        world = len(devices)
        tag = f"{backend} world of {world} ({', '.join(devices)})"
        t0 = time.perf_counter()
        res = mesh.spawn("chip_smoke:dp_rank", world, devices, backend,
                         [DP_BATCH, DP_FRAMES], timeout=DP_TIMEOUT,
                         pythonpath=[REPO])
        wall = time.perf_counter() - t0
        for r, o in enumerate(res):
            h, plan = o["hold"], "L" if o["rows"] <= edge else "T"
            print(f"[dp] {tag}, rank {r}: {o['rows']} streams x {DP_FRAMES} "
                  f"frames: launches {o['launches']}, by plan "
                  f"{o['plan_launches']}, the last under plan "
                  f"{o['last_plan'][0]} with clusters of {o['last_plan'][1]}"
                  f" (plan {plan} expected); {o['ms_per_frame']:.4f} ms per "
                  f"frame (host clock, with conditioning), gather "
                  f"{o['gather_ms']:.3f} ms; held against plain "
                  f"({GATE_FRAMES} frame): rng exact {h['rng_exact']}, pcm "
                  f"exact fraction {h['exact_frac']:.6f}, corr "
                  f"{h['corr']:.8f}, max |d| {h['max_abs_err']}, whole state "
                  f"equal {h['state_equal']}, the run's pcm is the kernel's "
                  f"{h['in_path']} [{card}]")
            if o["launches"]["flat"] != DP_FRAMES \
                    or sum(o["launches"].values()) != DP_FRAMES \
                    or o["plan_launches"][plan] != DP_FRAMES \
                    or o["last_plan"][0] != plan:
                raise RuntimeError(f"dp: {tag} rank {r} launched "
                                   f"{o['launches']} {o['plan_launches']}")
            if not (h["rng_exact"] and h["exact_frac"] >= GATE_EXACT
                    and h["corr"] >= GATE_CORR and h["in_path"]):
                raise RuntimeError(f"dp: {tag} rank {r}: the kernel "
                                   f"disagrees with the plain version")
        got = res[0]["pcm"]
        same = got is not None and torch.equal(got, ref)
        world_ms = max(o["ms_per_frame"] for o in res)
        print(f"[dp] {tag}: gathered pcm "
              f"{None if got is None else tuple(got.shape)} bit-identical to "
              f"one Synthesizer at B={DP_BATCH} with per-stream seeds: "
              f"{same}; the world {world_ms:.4f} ms per frame against one "
              f"Synthesizer {ref_ms:.4f} (host clock); {wall:.1f} s from "
              f"spawn to results [{card}]")
        if not same:
            raise RuntimeError(f"dp: {tag}: the gathered pcm differs from "
                               f"one Synthesizer's")

        B = 2 * world
        if B not in single:
            cfg, p0, opt, st, noise = mesh.dryrun_setup(dev)
            batch = {k: torch.as_tensor(a, device=dev) for k, a in
                     mesh.dryrun_batch(B, DP_TRAIN_FRAMES, cfg).items()}
            t0 = time.perf_counter()
            p1, _, m1 = lpcnet_task.train_step(p0, st, batch, cfg, opt,
                                               noise)
            torch.cuda.synchronize()
            single[B] = (float(m1["loss"]), [x.cpu() for x in
                                             optim.tree_leaves(p1)],
                         (time.perf_counter() - t0) * 1e3)
        loss1, leaves1, ms1 = single[B]
        tr = [o["train"] for o in res]
        leaves0 = optim.tree_leaves(tr[0]["params"])
        equal = all(torch.equal(a, b) for o in tr[1:]
                    for a, b in zip(leaves0, optim.tree_leaves(o["params"])))
        rel = abs(tr[0]["loss"] / loss1 - 1)
        worst = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(leaves0, leaves1))
        print(f"[dp] train, {tag}: dryrun_training_step (LPCNetConfig(), "
              f"B={B}, T={DP_TRAIN_FRAMES}): loss {tr[0]['loss']:.7f}, the "
              f"single-process step {loss1:.7f}, relative {rel:.3e} (gate "
              f"1e-5); ranks' parameters equal exactly {equal}; parameters "
              f"against the single-process step {worst:.3e} of a leaf's "
              f"largest entry (not gated: Adam's first step divides each "
              f"gradient by its own size); "
              f"{max(t['ms'] for t in tr):.1f} ms per step (single process "
              f"{ms1:.1f}; host clock) [{card}]")
        if not (equal and rel <= 1e-5):
            raise RuntimeError(f"dp: {tag}: the training step's ranks differ"
                               f" or its loss is off")
        for r, o in enumerate(res):
            g = o.get("graph")
            if backend != "nccl":
                if g is not None:
                    raise RuntimeError(f"dp: {tag}: a gloo rank graphed its "
                                       f"step")
                continue
            want = ({"mesh.dp_train_step": 1},
                    {"mesh.dp_train_step": DP_GRAPH_STEPS - 1})
            print(f"[dp] graphed dp_train_step, {tag}, rank {r}: "
                  f"{DP_GRAPH_STEPS} steps (LPCNetConfig(), B={B}, "
                  f"T={DP_TRAIN_FRAMES}) bit-identical to the eager steps "
                  f"(parameters, Adam state, metrics, the noise generator) "
                  f"{g['same']}; captures {g['captures']}, replays "
                  f"{g['replays']}; eager {g['eager_ms']:.1f} ms, replay "
                  f"{g['replay_ms']:.1f} ms per step "
                  f"({g['eager_ms'] / g['replay_ms']:.2f}x; host clock, "
                  f"synchronised), the capturing step {g['capture_call_s']:.3f}"
                  f" s (the capture {g['capture_s']:.3f} s); loss "
                  f"{g['loss']:.7f} [{card}]")
            if not g["same"] or (g["captures"], g["replays"]) != want:
                raise RuntimeError(f"dp: {tag} rank {r}: the graphed step "
                                   f"is not the eager one, or it captured "
                                   f"other than once")
        out[backend] = {
            "launches": sum(o["launches"]["flat"] for o in res),
            "max_abs_err": max(o["hold"]["max_abs_err"] for o in res)}
    return out


def trace_call(d: str, call, what: str, cpu: bool = True,
               launches=None, expect=None) -> dict:
    """utils/profiling.trace(cpu=cpu) around one call into d, and
    parse_trace_utilization over it. A trace that holds no sample-kernel
    event is printed with what it did hold and taken again, into d/1,
    d/2, at most TRACE_TRIES takes in all: the profiler has returned a
    trace of an eager graft call without its kernel's record, once in
    about 8 whole runs of this script. launches, where given, returns
    the wrappers' summed launch count, and each take must add expect to
    it: the call did launch its kernel, whatever its trace holds. Returns
    the utilization with "takes" added, and what the last take's call
    returned; raises RuntimeError naming what when no take holds a sample
    kernel."""
    from lpcnet_tpu_torch.utils import profiling
    for take in range(TRACE_TRIES):
        dd = os.path.join(d, str(take)) if take else d
        n0 = launches() if launches else None
        with profiling.trace(dd, cpu=cpu):
            out = call()
        if launches and launches() - n0 != expect:
            raise RuntimeError(f"{what}: the traced call launched "
                               f"{launches() - n0} sample kernels, not "
                               f"{expect}")
        u = profiling.parse_trace_utilization(dd)
        if u is not None and u["duty_cycle"] > 0:
            return {**u, "takes": take + 1}, out
        held = ("no device event" if u is None else
                f"{len(u['busy_us_by_class'])} kernel names "
                f"{list(u['busy_us_by_class'])[:3]}, no sample kernel")
        print(f"[trace] {what}: take {take + 1} of {TRACE_TRIES} holds "
              f"{held}"
              + (f"; the call launched {expect} sample kernels by the "
                 f"wrappers' counts" if launches else ""))
    raise RuntimeError(f"{what}: none of {TRACE_TRIES} traces holds a "
                       f"sample kernel")


def _short(name: str) -> str:
    """A kernel's name without its return type, arguments and long
    template arguments."""
    name = name.split("(")[0].replace("void ", "")
    return name if len(name) <= 60 else name[:57] + "..."

def profile_phase(dev, card, params, eng_b1) -> None:
    """Phase 4i: parse_trace_utilization over one traced call each of
    Synthesizer.synthesize (one frame at each of PROFILE_BATCHES) and
    PLCEngine.step at B=1 (phase 3's engine on its last frame), each traced
    twice: host operators and device (the trace() default) and the device
    alone (cpu=False); beside them the call's untraced time (host clock,
    synchronised). Fails unless every trace holds sample-kernel events and
    its occupancy lies in (0, 1]. Each traced frame's K1 launch is held
    against the plain loop on the same inputs; the PLC step's K3 launches
    are recorded by the caller for phase 5."""
    import tempfile
    import torch
    from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
    from lpcnet_tpu_torch.vocoder import Synthesizer
    v = Synthesizer(params=params, device=dev)
    cases = []
    for B in PROFILE_BATCHES:
        feats = tiled_features(B, 1)
        cases.append((f"Synthesizer.synthesize B={B}, one frame",
                      lambda st=v.reset(B, per_stream_rng=True), f=feats:
                      v.synthesize(st, f)[1], (B, feats)))
    eng, st, pcm_in, lost = eng_b1
    fr = torch.as_tensor(pcm_in[:, -FS:], device=dev)
    lo = torch.as_tensor(lost[:, -1], device=dev)
    cases.append(("PLCEngine.step B=1", lambda: eng.step(st, fr, lo)[1],
                  None))
    with tempfile.TemporaryDirectory() as tmp:
        for i, (what, fn, synth) in enumerate(cases):
            wall = host_ms(fn, 3)
            for cpu in (True, False):
                d = os.path.join(tmp, f"{i}{'hd' if cpu else 'd'}")
                u, out = trace_call(d, fn, f"profile: {what}", cpu=cpu)
                top = ", ".join(f"{_short(k)} {t:.1f}" for k, t in
                                list(u["busy_us_by_class"].items())[:3])
                print(f"[profile] {what}, trace of "
                      f"{'host and device' if cpu else 'the device alone'}: "
                      f"device occupancy {u['device_occupancy']:.4f}, sample-"
                      f"kernel duty cycle {u['duty_cycle']:.4f}, busy "
                      f"{u['busy_us']:.1f} of a {u['span_us']:.1f}-us span; "
                      f"top kernels by busy us: {top}; the call untraced "
                      f"{wall * 1e3:.1f} us (host clock) [{card}]")
                if not (0 < u["device_occupancy"] <= 1
                        and u["duty_cycle"] > 0):
                    raise RuntimeError(f"profile: {what}: occupancy "
                                       f"{u['device_occupancy']}, no sample "
                                       f"kernel in the trace")
            if synth is None:
                continue
            # the traced frame's K1 launch against the plain loop
            B, feats = synth
            st0 = v.reset(B, per_stream_rng=True)
            conds = v.conditions(feats)
            c = {k: conds[k].contiguous() for k in ("cond_a", "cond_b",
                                                     "lpc")}
            st_k, pcm_k = sample_cuda.synthesize_frames(v.tables, st0, c,
                                                        v.cfg)
            st_p, pcm_p = sample_scan.synthesize_frames(v.tables, st0, c,
                                                        v.cfg, flat=True)
            g = compare_pcm(pcm_k, pcm_p)
            ok = torch.equal(st_k["rng"], st_p["rng"]) \
                and g["exact_frac"] >= GATE_EXACT and g["corr"] >= GATE_CORR
            print(f"[profile] {what}: the traced pcm is the kernel's "
                  f"{torch.equal(out, pcm_k)}; kernel vs plain: pcm exact "
                  f"fraction {g['exact_frac']:.6f}, max |d| "
                  f"{g['max_abs_err']}, rng exact and gates met {ok}")
            if not (ok and torch.equal(out, pcm_k)):
                raise RuntimeError(f"profile: {what}: the kernel disagrees "
                                   f"with the plain version")


def bench_phase(dev, card, report, zero_counts) -> dict:
    """Phase 4j bench: lpcnet_tpu_torch.bench.main at its default sizes,
    BENCH_ITERS timed calls per throughput stage, on phase 4j's verify
    report (verify does not run again). Its lines print as [bench] lines.
    The bench calls the graphed entry points (utils/graphs.py): each
    stage's warm-up calls run the first call of its shape eagerly and
    capture the second, and the timed calls replay it. Through main's
    on_stage the counts are set to 0 just before each stage and read just
    after: the headline launches K1 (flat) once per frame under plan T,
    the latency stage once per call under plan L at B=1 and B=8, the PLC
    stage K3 once per step under plan T, each from the host in the eager
    call and the capture of its graph and never in a replay, and no other
    stage launches a sample kernel; the graphs captured and replayed per
    stage (graphs.captures, graphs.replays) are counted beside them (the
    train stage's lpcnet_task.train_step too: its timed steps replay), and
    the launches the card ran are the eager ones plus the replays times a
    captured call's. The headline's first frame and the latency stage's
    eager call at B=1 and at B=8 are held against the plain loop on their
    own state and conditions (phase 2's gates), their pcm the kernel's;
    so are the last replay of each of those graphs, its inputs and
    outputs read from the graph's own tensors after the stage, and the
    replay's pcm and state are bit-identical to an eager kernel call on
    the same inputs. The headline's window is then timed untraced.
    Returns the K1 keys of the kernels line and the PLC stage's K3
    launches."""
    import contextlib
    import io
    import torch
    from lpcnet_tpu_torch import bench, data
    from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
    from lpcnet_tpu_torch.training import lpcnet_task
    from lpcnet_tpu_torch.utils import graphs
    from lpcnet_tpu_torch.vocoder import Synthesizer
    synth = sample_cuda.synthesize_frames
    counts, calls, held, captured = {}, [], {}, {}

    @contextlib.contextmanager
    def on_stage(name):
        zero_counts()
        calls.clear()
        yield
        torch.cuda.synchronize()
        counts[name] = (dict(sample_cuda.launches),
                        dict(sample_cuda.plan_launches), list(calls),
                        dict(graphs.captures), dict(graphs.replays))

    def frames(tables, state, conds, cfg, variant="flat"):
        """synthesize_frames, keeping each call's batch, launches by plan
        and whether a graph captured it, the arguments and pcm of the first
        eager call at each batch (the state copied), and the tensors of
        the first capture at each batch: the graph's own, which hold the
        last replay's inputs and outputs."""
        before = dict(sample_cuda.plan_launches)
        st, pcm = synth(tables, state, conds, cfg, variant=variant)
        B = conds["cond_a"].shape[0]
        capturing = _capturing()
        calls.append((B, {p: sample_cuda.plan_launches[p] - n
                          for p, n in before.items()}, capturing))
        if capturing:
            captured.setdefault(B, {"args": (tables, state, conds, cfg),
                                    "st": st, "pcm": pcm,
                                    "variant": variant})
        else:
            held.setdefault(B, {"args": (tables, {k: v.clone()
                                                  for k, v in state.items()},
                                         conds, cfg),
                                "pcm": pcm, "variant": variant})
        return st, pcm

    buf = io.StringIO()
    t0 = time.perf_counter()
    data.feature_step(False).clear()    # its stage's calls start afresh
    try:
        sample_cuda.synthesize_frames = frames
        with contextlib.redirect_stdout(buf):
            lines = bench.main(["--device", str(dev)], iters=BENCH_ITERS,
                               report=report, on_stage=on_stage)
    finally:
        sample_cuda.synthesize_frames = synth
        for line in buf.getvalue().splitlines():
            print(f"[bench] {line}")
        lpcnet_task.train_step.clear()      # the train stage's graph
    print(f"[bench] {len(lines)} lines in {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    got = tuple(d["metric"] for d in lines)
    if got != BENCH_METRICS:
        raise RuntimeError(f"bench: lines {got}, expected {BENCH_METRICS}")
    bad = [d["metric"] for d in lines
           if not (np.isfinite(d["value"]) and d["value"] > 0)]
    if bad or lines[BENCH_METRICS.index("on_device_verify")]["value"] != 1.0:
        raise RuntimeError(f"bench: lines without a positive value {bad}, "
                           f"or verify below 1.0")

    def expect(stage, kernel, n, plan, by_batch=None, graphed=None):
        """n launches of kernel from the host under plan; by_batch: calls
        of the frame kernel per batch; graphed: {entry point: (captures,
        replays)}. Returns the launches from the host."""
        launches, plans, frame_calls, made, replayed = counts[stage]
        got = {e: (made.get(e, 0), replayed.get(e, 0))
               for e in set(made) | set(replayed)}
        print(f"[bench] {stage}: launches from the host {launches}, by plan "
              f"{plans}; graphs (captures, replays) {got}")
        if launches.get(kernel, 0) != n or sum(launches.values()) != n \
                or (n and plans[plan] != n):
            raise RuntimeError(f"bench: {stage}: expected {n} {kernel} "
                               f"launches under plan {plan}")
        if graphed is not None and got != graphed:
            raise RuntimeError(f"bench: {stage}: graphs {got}, expected "
                               f"{graphed}")
        for B, nb in (by_batch or {}).items():
            got = [d for b, d, _ in frame_calls if b == B]
            if len(got) != nb or any(d != {plan: 1, **{p: 0 for p in d
                                                       if p != plan}}
                                     for d in got):
                raise RuntimeError(f"bench: {stage}: B={B} took "
                                   f"{len(got)} calls, {got[:3]}")
        return launches[kernel] if n else 0

    # each graph launches from the host in its eager call and its capture;
    # of n calls of one signature, all but the w - 1 eager ones replay
    w = graphs.CAPTURE_CALL
    synth_name, plc_name = "Synthesizer.synthesize", "PLCEngine.step"
    n_head = expect("bench_synthesis", "flat", HEAD_FRAMES * w, "T",
                    graphed={synth_name: (1, 1 + HEAD_ITERS)})
    expect("bench_latency", "flat", 2 * w, "L", {1: w, 8: w},
           graphed={synth_name: (2, 2 * (1 + LATENCY_ITERS))})
    # run() steps BENCH_PLC_FRAMES frames a call, w + BENCH_ITERS calls
    n_plc = expect("bench_plc", "tf_flat", w, "T", graphed={
        plc_name: (1, BENCH_PLC_FRAMES * (w + BENCH_ITERS) - (w - 1))})
    # encode: w + BENCH_ITERS calls timed and one more for decode's input
    expect("bench_dred", "flat", 0, "T", graphed={
        "DREDCodec.encode": (1, BENCH_ITERS + 2),
        "DREDCodec.decode": (1, BENCH_ITERS + 1)})
    # the train stage's step: an eager call, a capture, BENCH_ITERS replays
    expect("bench_train", "flat", 0, "T", graphed={
        "lpcnet_task.train_step": (1, BENCH_ITERS + 1)})
    # the feature and codec steps (data.py): their input features are one
    # eager compute_features call; encode's one more call makes decode's
    # input
    expect("bench_features", "flat", 0, "T", graphed={
        data.feature_step(False).name: (1, BENCH_ITERS + 1)})
    expect("bench_codec", "flat", 0, "T", graphed={
        "data.encode_superframes": (1, BENCH_ITERS + 2),
        "data.decode_packets": (1, BENCH_ITERS + 1)})
    for stage in counts:
        if stage not in ("bench_synthesis", "bench_latency", "bench_plc",
                         "bench_dred", "bench_train", "bench_features",
                         "bench_codec"):
            expect(stage, "flat", 0, "T", graphed={})

    def host_and_device(stage, B, replays):
        """K1's launches from the host at batch B in the stage (the eager
        calls' and the capture's) and the launches the card ran: the eager
        calls' and `replays` times the captured call's."""
        frame_calls = counts[stage][2]
        eager = sum(sum(d.values()) for b, d, cap in frame_calls
                    if b == B and not cap)
        per_call = [sum(d.values()) for b, d, cap in frame_calls
                    if b == B and cap]
        if len(per_call) != 1:
            raise RuntimeError(f"bench: {stage}: B={B} captured "
                               f"{len(per_call)} calls")
        return eager + per_call[0], eager + replays * per_call[0]

    host, dev_n = {}, {}
    host["headline"], dev_n["headline"] = host_and_device(
        "bench_synthesis", HEAD_BATCH, 1 + HEAD_ITERS)
    for B in (1, 8):
        host[B], dev_n[B] = host_and_device("bench_latency", B,
                                            1 + LATENCY_ITERS)
    if host["headline"] != n_head:
        raise RuntimeError("bench: the headline's launches by call do not "
                           "add up")
    plc_replays = counts["bench_plc"][4][plc_name]
    plc_dev = (n_plc - 1) + plc_replays      # one of them in the capture
    print(f"[bench] launches the card ran (eager calls and replays; from "
          f"the host in brackets): headline K1 {dev_n['headline']} "
          f"({host['headline']}), latency K1 B=1 {dev_n[1]} ({host[1]}), "
          f"B=8 {dev_n[8]} ({host[8]}), PLC K3 {plc_dev} ({n_plc})")

    # the headline's first frame, and the latency stage's eager call at
    # B=1 and at B=8, against the plain loop; then the last replay of each
    # of their graphs: against an eager kernel call on its own inputs, bit
    # for bit, and against the plain loop
    errs = {}
    for B, what in ((HEAD_BATCH, "headline"), (1, "latency"),
                    (8, "latency")):
        for kind, h in (("its eager call", held[B]),
                        ("its last replay", captured[B])):
            tables, st0, conds, cfg = h["args"]
            st0 = {k: v.clone() for k, v in st0.items()}
            conds = {k: conds[k].clone() for k in ("cond_a", "cond_b",
                                                   "lpc")}
            replay_ok = True
            if "st" in h:
                st_e, pcm_e = synth(tables, st0, conds, cfg,
                                    variant=h["variant"])
                replay_ok = torch.equal(pcm_e, h["pcm"]) and all(
                    torch.equal(v, h["st"][k]) for k, v in st_e.items())
            c = {k: conds[k][:, :GATE_FRAMES].contiguous() for k in conds}
            st_k, pcm_k = synth(tables, st0, c, cfg)
            st_p, pcm_p = plain_frames(sample_scan, "flat", tables, st0, c,
                                       cfg)
            g = compare_pcm(pcm_k, pcm_p)
            rng_ok = torch.equal(st_k["rng"], st_p["rng"])
            in_path = (h["variant"] == "flat"
                       and torch.equal(h["pcm"][:, :GATE_FRAMES * FS],
                                       pcm_k))
            print(f"[bench] {what} B={B}, {kind}, its first "
                  f"{GATE_FRAMES} frame(s) vs plain: rng exact {rng_ok}, pcm "
                  f"exact fraction {g['exact_frac']:.6f} (gate >= "
                  f"{GATE_EXACT}), corr {g['corr']:.8f} (gate >= "
                  f"{GATE_CORR}), max |d| {g['max_abs_err']}; the run's pcm "
                  f"is the kernel's {in_path}"
                  + (f"; pcm and state bit-identical to an eager call on "
                     f"the replay's inputs {replay_ok}" if "st" in h else "")
                  + f" [{card}]")
            if not (rng_ok and g["exact_frac"] >= GATE_EXACT
                    and g["corr"] >= GATE_CORR and in_path and replay_ok):
                raise RuntimeError(f"bench: {what} B={B}, {kind}: the kernel "
                                   f"disagrees with the plain version or "
                                   f"the replay with the eager call")
            errs[B] = max(errs.get(B, 0.0), g["max_abs_err"])

    # the same window untraced
    head = lines[-1]["value"]
    util = lines[BENCH_METRICS.index("sample_kernel_duty_cycle")]
    v = Synthesizer(device=dev)
    dt = bench._timed_synthesis(
        v.synthesize, v.reset(HEAD_BATCH, per_stream_rng=True),
        bench._random_features(HEAD_BATCH, HEAD_FRAMES, dev), HEAD_ITERS,
        dev, None)
    rt = HEAD_ITERS * HEAD_BATCH * HEAD_FRAMES * 0.01 / dt
    print(f"[bench] headline window B={HEAD_BATCH} x {HEAD_FRAMES} frames x "
          f"{HEAD_ITERS} calls: RT {head}x traced (the device alone; "
          f"occupancy {util['device_occupancy']}, sample-kernel duty cycle "
          f"{util['value']}%), {rt:.2f}x untraced, "
          f"{dt * 1e3 / (HEAD_ITERS * HEAD_FRAMES):.4f} ms per frame "
          f"untraced (host clock) [{card}]")
    return {"k1": {"host_launches_bench_headline": host["headline"],
                   "device_launches_bench_headline": dev_n["headline"],
                   "host_launches_bench_latency_b1": host[1],
                   "device_launches_bench_latency_b1": dev_n[1],
                   "host_launches_bench_latency_b8": host[8],
                   "device_launches_bench_latency_b8": dev_n[8],
                   "max_abs_err_bench": errs[HEAD_BATCH],
                   "max_abs_err_bench_latency_b1": errs[1],
                   "max_abs_err_bench_latency_b8": errs[8]},
            "plc": {"host_launches_bench_plc": n_plc,
                    "device_launches_bench_plc": plc_dev}}


def graft_phase(dev, card, zero_counts, edge) -> dict:
    """Phase 4k: graft_entry.entry() at each of GRAFT_BATCHES, its fn
    called eagerly on two argument sets (counts set to 0 just before, read
    just after: one K1 launch per call under plan L) and held against the
    plain loop with phase 2's gates; compile_step's replay bit-identical to
    the eager call on both sets; eager calls and replays timed and traced;
    then dryrun_multichip over every visible card. Returns the K1 row's
    graft keys; raises RuntimeError on a failed check."""
    import tempfile
    import torch
    from lpcnet_tpu_torch import graft_entry
    from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
    from lpcnet_tpu_torch.vocoder import Synthesizer
    golden = np.fromfile(FEATS, np.float32).reshape(-1, 36)
    v = Synthesizer(device=dev)          # the entry's weights, for the holds
    launches = replays = 0
    errs, times = [], {}
    same = graft_entry.same_output
    for B in GRAFT_BATCHES:
        if B > edge:
            raise RuntimeError(f"graft: B={B} is beyond plan L")
        fn, args = graft_entry.entry(batch=B)
        offs = np.random.RandomState(B).randint(0, len(golden), B)
        feats2 = torch.as_tensor(golden[offs][:, None], device=dev)
        fn(*args)                                                  # warm
        torch.cuda.synchronize()
        zero_counts()
        eager = fn(*args)
        sets = [(args, eager), ((eager[0], feats2), fn(eager[0], feats2))]
        torch.cuda.synchronize()
        counts = dict(sample_cuda.launches)
        by_plan = dict(sample_cuda.plan_launches)
        tag = f"entry() B={B} x 1 frame"
        print(f"[graft] {tag}: launches of 2 eager calls {counts}, by plan "
              f"{by_plan}, the last under plan {sample_cuda.last_plan[0]}")
        if counts["flat"] != 2 or sum(counts.values()) != 2 \
                or by_plan["L"] != 2 or sample_cuda.last_plan[0] != "L":
            raise RuntimeError(f"graft: {tag} launched {counts} {by_plan}")
        launches += counts["flat"]
        for i, ((st, f), out) in enumerate(sets):
            conds = v.conditions(f)
            c = {k: conds[k].contiguous() for k in ("cond_a", "cond_b",
                                                     "lpc")}
            plain = plain_frames(sample_scan, "flat", v.tables, st, c,
                                 v.cfg)
            g = compare_pcm(out[1], plain[1])
            rng_ok = torch.equal(out[0]["rng"], plain[0]["rng"])
            errs.append(g["max_abs_err"])
            print(f"[graft] {tag}, argument set {i + 1}: eager vs plain: rng"
                  f" exact {rng_ok}, pcm exact fraction "
                  f"{g['exact_frac']:.6f}, corr {g['corr']:.8f}, max |d| "
                  f"{g['max_abs_err']}, bit-identical {same(out, plain)}")
            if not (rng_ok and g["exact_frac"] >= GATE_EXACT
                    and g["corr"] >= GATE_CORR):
                raise RuntimeError(f"graft: {tag}: the eager step disagrees "
                                   f"with the plain loop")
        t0 = time.perf_counter()
        step = graft_entry.compile_step(fn, args)
        capture_s = time.perf_counter() - t0
        held = [same(step(*a), out) for a, out in sets]
        torch.cuda.synchronize()
        replays += step.replays
        print(f"[graft] {tag}: captured as one CUDA graph in {capture_s:.2f} "
              f"s (warm-up included); replay bit-identical to the eager "
              f"call (pcm and every state leaf) on argument set 1 "
              f"{held[0]}, set 2 {held[1]}")
        if not all(held):
            raise RuntimeError(f"graft: {tag}: the replay differs from the "
                               f"eager call")
        eager_ms = host_ms(lambda: fn(*args), GRAFT_REPS)
        replay_ms = host_ms(lambda: step(*args), GRAFT_REPS)
        # the graph alone, without the step's input copies and output clones
        graph_ms = cuda_ms(step.graph.replay, GRAFT_REPS)
        # each call traced alone GRAFT_TRACES times: a traced replay's span
        # stretches to 1.0-2.9x the graph's untraced time, by an amount that
        # differs between processes, while its busy time stays put
        occ, spread, takes = {}, {}, 0

        def launched():
            return sum(sample_cuda.launches.values())

        with tempfile.TemporaryDirectory() as tmp:
            for what, call in (("eager", lambda: fn(*args)),
                               ("replay", lambda: step(*args))):
                us = [trace_call(os.path.join(tmp, f"{what}{i}"), call,
                                 f"graft: {tag}: the {what} call", cpu=False,
                                 launches=launched,
                                 expect=1 if what == "eager" else 0)[0]
                      for i in range(GRAFT_TRACES)]
                takes += sum(u["takes"] for u in us)
                us.sort(key=lambda u: u["device_occupancy"])
                occ[what] = us[len(us) // 2]
                spread[what] = (us[0]["device_occupancy"],
                                us[-1]["device_occupancy"])
        # the replay's busy time over the graph's untraced time: the
        # device's share of the graph, which the trace's span cannot give
        busy_share = occ["replay"]["busy_us"] / (graph_ms * 1e3)
        times[f"b{B}"] = {"eager_ms": eager_ms, "replay_ms": replay_ms,
                          "graph_ms": graph_ms,
                          "graph_busy_share": busy_share, **{
                              f"{w}_{k}": occ[w][k] for w in occ
                              for k in ("device_occupancy", "busy_us")}}
        print(f"[graft] {tag}: eager {eager_ms:.4f} ms per call, replay "
              f"{replay_ms:.4f} ms (host clock, synchronised, {GRAFT_REPS} "
              f"calls each after a warm-up; {eager_ms / replay_ms:.2f}x), "
              f"the graph alone {graph_ms:.4f} ms (CUDA events); the "
              f"median of {GRAFT_TRACES} traced calls (device alone): eager "
              f"occupancy {occ['eager']['device_occupancy']:.4f} (range "
              f"{spread['eager'][0]:.4f}-{spread['eager'][1]:.4f}), busy "
              f"{occ['eager']['busy_us']:.1f} of a "
              f"{occ['eager']['span_us']:.1f}-us span, replay "
              f"{occ['replay']['device_occupancy']:.4f} (range "
              f"{spread['replay'][0]:.4f}-{spread['replay'][1]:.4f}), busy "
              f"{occ['replay']['busy_us']:.1f} of "
              f"{occ['replay']['span_us']:.1f} us, {busy_share:.4f} of the "
              f"graph alone; sample-kernel duty cycle "
              f"{occ['eager']['duty_cycle']:.4f} and "
              f"{occ['replay']['duty_cycle']:.4f}; {takes} takes for "
              f"{2 * GRAFT_TRACES} traces [{card}]")
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(n)
    tr = res["train"]
    print(f"[graft] dryrun_multichip({n}): training step loss "
          f"{tr[0]['loss']:.7f}, {max(t['ms'] for t in tr):.1f} ms per step; "
          f"stream-parallel synthesis per rank "
          f"{[r['shape'] for r in res['inference']]}, gathered "
          f"{res['inference'][0]['gathered']}; {time.perf_counter() - t0:.1f}"
          f" s [{card}]")
    return {"launches_graft": launches, "replays_graft": replays,
            "max_abs_err_graft": max(errs), "graft_ms": times}


def _same_tree(a, b) -> bool:
    """Two results of an entry point are bit-identical: every tensor leaf
    of the trees equal, and the trees of one structure."""
    import torch
    from lpcnet_tpu_torch.utils import graphs
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    return sa == sb and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _median_call_ms(fn, reps: int) -> float:
    """Median of reps calls of fn, each by the host clock and synchronised
    before and after."""
    import torch
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def call_chain(method, state, calls, ms=None):
    """The calls in order, each on the state the last one left (state
    None: a stateless entry point); ms: a list that gets each call's ms
    (host clock, synchronised)."""
    import torch
    outs = []
    for a in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(method(*a) if state is None else method(state, *a))
        state = None if state is None else outs[-1][0]
        torch.cuda.synchronize()
        if ms is not None:
            ms.append((time.perf_counter() - t0) * 1e3)
    return outs


def graph_cases(dev, params, plc_params, dred):
    """The graphed entry points of phase 4l, each as (name, what, B, plain,
    make), plain for an entry point that runs the plain loops: make()
    gives (the object, its jit, the public method, the initial state or
    None for a stateless call, the arguments of each call after the state,
    the sample-kernel launches of one call by counter)."""
    import torch
    from lpcnet_tpu_torch import plc
    from lpcnet_tpu_torch.dred import DREDCodec
    from lpcnet_tpu_torch.vocoder import Synthesizer
    n, T = GRAPH_CALLS, GRAPH_FRAMES
    cases = []

    def split(x, frames, per_frame):
        """x (B, n * frames * per_frame, ...) as n per-call pieces."""
        w = frames * per_frame
        return [x[:, i * w:(i + 1) * w] for i in range(len(x[0]) // w)]

    for B in GRAPH_BATCHES:
        feats = tiled_features(B, n * T)
        for variant in ("flat", "base", "fuse", "opt"):
            for tables in ("f32", "bf16"):
                def make(B=B, variant=variant, tables=tables, feats=feats):
                    v = Synthesizer(params=params, device=dev,
                                    variant=variant, tables=tables)
                    counter = variant + ("_bf16" if tables == "bf16" else "")
                    return (v, v._synth, v.synthesize,
                            v.reset(B, per_stream_rng=True),
                            [(f,) for f in split(feats, T, 1)], {counter: T})
                cases.append(("Synthesizer.synthesize",
                              f"{variant} {tables}", B, False, make))

        def make_teacher(B=B, feats=feats):
            v = Synthesizer(params=params, device=dev)
            target = tiled_speech(B, n * T)
            preload = np.random.RandomState(9).randint(0, FS + 1, (B, n * T))
            args = list(zip(split(feats, T, 1), split(target, T, FS),
                            split(preload, T, 1)))
            return (v, v._synth_teacher, v.synthesize_teacher,
                    v.reset(B, per_stream_rng=True), args, {"tf_flat": T})
        cases.append(("Synthesizer.synthesize_teacher", "preload", B,
                      False, make_teacher))

        def make_streaming(B=B, feats=feats):
            v = Synthesizer(params=params, device=dev)
            return (v, v._synth_streaming, v.synthesize_streaming,
                    v.reset_streaming(B, True),
                    [(f,) for f in split(feats, T, 1)], {"tf_flat": T})
        cases.append(("Synthesizer.synthesize_streaming", "K3", B, False,
                      make_streaming))

        speech = tiled_speech(B, GRAPH_STEPS)
        lost = loss_flags(B, GRAPH_STEPS)
        if B == 1:           # one stream: a good, a lost, a blend frame
            lost[0] = [False, True, False, False][:GRAPH_STEPS]
        for cls, per_step in (
                (plc.PLCEngine, {"tf_flat": 1}),
                (plc.NonCausalPLCEngine, {"tf_flat": 4, "teacher": 3}),
                (plc.StrictCausalPLCEngine, {"tf_flat": 8})):
            def make_plc(B=B, cls=cls, per_step=per_step, speech=speech,
                         lost=lost):
                eng = cls(params, plc_params, device=dev)
                args = [(speech[:, t * FS:(t + 1) * FS], lost[:, t])
                        for t in range(GRAPH_STEPS)]
                return (eng, eng._step, eng.step, eng.init_state(B), args,
                        per_step)
            cases.append((cls.__name__ + ".step", "", B, False, make_plc))

        dparams, dcfg = dred
        dfeats = tiled_features(B, n * DRED_GRAPH_FRAMES)[..., :20]

        def make_encode(B=B, dfeats=dfeats):
            dc = DREDCodec(dparams, dcfg, device=dev)
            return (dc, dc._encode, dc.encode, None,
                    [(f,) for f in split(dfeats, DRED_GRAPH_FRAMES, 1)], {})
        cases.append(("DREDCodec.encode", "", B, False, make_encode))

        def make_decode(B=B, dfeats=dfeats):
            dc = DREDCodec(dparams, dcfg, device=dev)
            args = []
            with torch.no_grad():
                for f in split(dfeats, DRED_GRAPH_FRAMES, 1):
                    zd, sd = dc._encode_impl(torch.as_tensor(f, device=dev))
                    sym, qid = dc.quantize_payload(zd)
                    args.append((sym, qid, sd[:, 0]))
            return dc, dc._decode, dc.decode, None, args, {}
        cases.append(("DREDCodec.decode", "", B, False, make_decode))

    # the dotprod plain loops on the card (seconds per eager frame): B=1,
    # GRAPH_PLAIN_CALLS calls of 1 frame
    feats1 = tiled_features(1, GRAPH_PLAIN_CALLS)
    for name in ("Synthesizer.synthesize", "Synthesizer.synthesize_streaming"):
        def make_plain(name=name):
            v = Synthesizer(params=params, device=dev, backend="dotprod")
            streaming = "streaming" in name
            step = v._synth_streaming if streaming else v._synth
            state = (v.reset_streaming(1, True) if streaming
                     else v.reset(1, per_stream_rng=True))
            method = getattr(v, name.split(".")[1])
            return (v, step, method, state,
                    [(f,) for f in split(feats1, 1, 1)], {})
        cases.append((name, "dotprod", 1, True, make_plain))
    return cases


def graphs_phase(dev, card, params, plc_params, zero_counts) -> dict:
    """Phase 4l: every graphed entry point (utils/graphs.jit) at B=1 (plan
    L) and B=1024 (plan T), the dotprod plain loops at B=1 x 1 frame: a
    chain of calls that carries the state under graphs.disabled() (eager),
    then the same chain graphed, pcm and every state leaf bit-identical;
    the first graphed call runs eagerly, the second captures (its time is
    the capture call's), it and the later ones replay. Counts set to 0
    just before the graphed chain and read after it: every launch is the
    eager call's or the capture's, CAPTURE_CALL x one call's, under the
    batch's plan; the replays launch nothing from the host. Then eager and
    replayed ms per call (host clock, synchronised, the median of
    GRAPH_REPS calls; for the plain loops, which take seconds per eager
    call, the eager chain's calls and GRAPH_PLAIN_REPS replays), the
    capture alone (CompiledStep.capture_s) and the peak memory. Then
    synthesize_temperature (temperature_lines) and the other jit sites
    (jit_site_lines). Then one-shot
    callers: a fresh synthesizer's first, second and third call at B=1 x
    ONE_SHOT_FRAMES frames beside one eager call. Then one frame per call
    at B=1 and B=8, eager and replayed. Raises RuntimeError on a failed
    check; returns the lines' numbers."""
    import torch
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.kernels import sample_cuda
    from lpcnet_tpu_torch.utils import graphs
    from lpcnet_tpu_torch.vocoder import Synthesizer
    t_phase = time.perf_counter()
    dred = convert.load_dred(device=dev)
    w = graphs.CAPTURE_CALL
    out = {}

    chain = call_chain

    for name, what, B, plain, make in graph_cases(dev, params, plc_params,
                                                  dred):
        obj, step, method, state0, args, per_call = make()
        tag = f"{name}{' ' + what if what else ''} B={B}"
        chain_ms = []
        zero_counts()
        with graphs.disabled():
            eager = chain(method, state0, args, chain_ms)
        if graphs.captures or graphs.replays:
            raise RuntimeError(f"graphs: {tag}: captured while disabled")
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        graphed_ms = []
        graphed = chain(method, state0, args[:w], graphed_ms)
        graphed += chain(method, None if state0 is None else graphed[-1][0],
                         args[w:])
        peak = torch.cuda.max_memory_allocated()
        counts = {k: c for k, c in sample_cuda.launches.items() if c}
        by_plan = dict(sample_cuda.plan_launches)
        same = len(eager) == len(graphed) and all(
            _same_tree(e, g) for e, g in zip(eager, graphed))
        want = {k: w * c for k, c in per_call.items()}
        plan = "L" if B <= sample_cuda.TILE * sample_cuda.max_clusters(dev) \
            else "T"
        n_want = sum(want.values())
        # the plain loops take seconds per eager call: their eager ms is the
        # median of the eager chain's calls
        reps = GRAPH_PLAIN_REPS if plain else GRAPH_REPS
        call0 = ((lambda: method(*args[0])) if state0 is None
                 else (lambda: method(state0, *args[0])))
        if plain:
            eager_ms = float(np.median(chain_ms))
        else:
            with graphs.disabled():
                eager_ms = _median_call_ms(call0, reps)
        replays0 = graphs.replays[name]
        replay_ms = _median_call_ms(call0, reps)
        ok = (same and dict(graphs.captures) == {name: 1} and counts == want
              and by_plan[plan] == n_want and sum(by_plan.values()) == n_want
              and replays0 == len(args) - (w - 1)
              and dict(graphs.replays) == {name: replays0 + reps})
        capture_only = next(iter(step.steps.values())).capture_s
        line = {"first_call_ms": graphed_ms[0],
                "capture_call_s": graphed_ms[w - 1] / 1e3,
                "capture_s": capture_only, "eager_ms": eager_ms,
                "replay_ms": replay_ms, "captures": graphs.captures[name],
                "replays": graphs.replays[name], "mem_gb": mem0 / 2 ** 30,
                "peak_gb": peak / 2 ** 30, "same": same}
        out[(name, what, B)] = line
        limit = ""
        if name == "PLCEngine.step" and B == 1:
            limit = (f"; limit {PLC_STEP_LIMIT_MS} ms per step: "
                     f"{'met' if replay_ms < PLC_STEP_LIMIT_MS else 'missed'}")
        print(f"[graphs] {tag} x {len(args)} calls"
              f"{'' if state0 is None else ' carrying the state'}: "
              f"bit-identical to the eager chain (pcm and every state leaf) "
              f"{same}; the first call (eager) {graphed_ms[0]:.4f} ms, the "
              f"capturing call {graphed_ms[w - 1] / 1e3:.3f} s (the capture "
              f"{capture_only:.3f} s and a replay); eager {eager_ms:.4f} ms, "
              f"replay {replay_ms:.4f} ms per call "
              f"({eager_ms / replay_ms:.2f}x; host clock, synchronised, "
              f"median of {len(chain_ms) if plain else reps}"
              f"{' eager' if plain else ''} calls"
              f"{f', {reps} replays' if plain else ''}){limit}; captures "
              f"{graphs.captures[name]}, replays {graphs.replays[name]}; "
              f"launches from the host {counts} (by plan {by_plan}; "
              f"expected {want} under plan {plan}); memory "
              f"{mem0 / 2 ** 30:.3f} GiB before the graphed chain, peak "
              f"{peak / 2 ** 30:.3f} GiB [{card}]")
        if not ok:
            raise RuntimeError(f"graphs: {tag}: the graphed chain is not the "
                               f"eager one, or its captures, replays or "
                               f"launches are not as expected")
        del obj, step, method, eager, graphed

    # synthesize_temperature: its conditioning jit and its sample step
    # captured once per batch size and replayed FS times per frame
    out.update(temperature_lines(dev, card, params))
    # the other jit sites: the feature and codec steps, the k-means
    # updates and the tools' steps
    out.update(jit_site_lines(dev, card))

    # one-shot callers: a CLI chunk (cli.CHUNK_FRAMES) and eval_lpcnet's
    # one call on the golden features
    whole = np.fromfile(FEATS, np.float32).reshape(1, -1, 36)
    name = "Synthesizer.synthesize"
    for T in ONE_SHOT_FRAMES:
        f = torch.as_tensor(whole[:, :T], device=dev)
        v = Synthesizer(params=params, device=dev)
        st = v.reset(1)
        with graphs.disabled():
            eager_ms = []
            (_, pcm_e), = chain(lambda f: v.synthesize(st, f), None, [(f,)],
                                eager_ms)
        v = Synthesizer(params=params, device=dev)
        zero_counts()
        ms = []
        # each call on the same fresh state, as separate one-shot calls
        outs = chain(lambda f: v.synthesize(st, f), None, [(f,)] * 3, ms)
        got = (dict(graphs.captures), dict(graphs.replays))
        same = all(torch.equal(o[1], pcm_e) for o in outs)
        out[("one-shot", "", T)] = {"eager_ms": eager_ms[0], "calls_ms": ms,
                                    "same": same}
        print(f"[graphs] one-shot {name} B=1 x {T} frames (a fresh "
              f"synthesizer, one eager call beside its first three calls "
              f"of one shape): eager {eager_ms[0]:.2f} ms; graphed: the "
              f"first call {ms[0]:.2f} ms (eager), the second "
              f"{ms[1]:.2f} ms (the capture and a replay), the third "
              f"{ms[2]:.2f} ms (a replay); a capture in the first call "
              f"would have made it ~{ms[0] + ms[1]:.2f} ms; (captures, "
              f"replays) {got}; every call's pcm equal to the eager call's "
              f"{same} [{card}]")
        if not (same and got == ({name: 1}, {name: 2})):
            raise RuntimeError(f"graphs: one-shot B=1 x {T}: the calls "
                               f"disagree or captured other than once")
        del v
    # one frame per call, the bench's latency shape, eager and replayed in
    # this run
    for B in (1, 8):
        v = Synthesizer(params=params, device=dev)
        f = torch.as_tensor(tiled_features(B, 1), device=dev)
        st = v.reset(B, per_stream_rng=True)
        with graphs.disabled():
            eager_ms = _median_call_ms(lambda: v.synthesize(st, f),
                                       LATENCY_REPS)
            _, pcm_e = v.synthesize(st, f)
        for _ in range(w):
            v.synthesize(st, f)
        replay_ms = _median_call_ms(lambda: v.synthesize(st, f),
                                    LATENCY_REPS)
        same = torch.equal(v.synthesize(st, f)[1], pcm_e)
        out[("one frame", "", B)] = {"eager_ms": eager_ms,
                                     "replay_ms": replay_ms, "same": same}
        print(f"[graphs] one frame per call {name} B={B}: eager "
              f"{eager_ms:.4f} ms, replay {replay_ms:.4f} ms (host clock, "
              f"synchronised, median of {LATENCY_REPS} calls each; limit "
              f"10 ms: {'met' if replay_ms < 10 else 'missed'} graphed, "
              f"{'met' if eager_ms < 10 else 'missed'} eager); the replay's "
              f"pcm equal to the eager call's {same} [{card}]")
        if not same:
            raise RuntimeError(f"graphs: one frame B={B}: the replay "
                               f"disagrees with the eager call")
        del v
    print(f"[graphs] {len(out)} lines in "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


def temperature_lines(dev, card, params) -> dict:
    """Synthesizer.synthesize_temperature at each of GRAPH_BATCHES:
    TEMP_CALLS calls of one frame that carry the state under
    graphs.disabled(), then the same graphed (the conditioning a jit, the
    sample step a graphs.loop_step: the first step eager, the second
    captured, every later one a replay), pcm and every state leaf
    bit-identical; ms per frame eager (the median of the eager calls) and
    graphed (the median of the calls after the first, all replays), the
    step's capture s. Raises RuntimeError on a failed check."""
    import torch
    from lpcnet_tpu_torch.utils import graphs
    from lpcnet_tpu_torch.vocoder import Synthesizer
    name = "Synthesizer.synthesize_temperature"
    out = {}
    for B in GRAPH_BATCHES:
        v = Synthesizer(params=params, device=dev)
        feats = torch.as_tensor(tiled_features(B, TEMP_CALLS), device=dev)
        calls = [(feats[:, i:i + 1],) for i in range(TEMP_CALLS)]
        st = v.reset(B, per_stream_rng=True)
        eager_ms, graphed_ms = [], []
        with graphs.disabled():
            eager = call_chain(v.synthesize_temperature, st, calls,
                               eager_ms)
        v = Synthesizer(params=params, device=dev)
        graphs.captures.clear()
        graphs.replays.clear()
        graphed = call_chain(v.synthesize_temperature, st, calls,
                             graphed_ms)
        same = all(_same_tree(e, g) for e, g in zip(eager, graphed))
        got = (dict(graphs.captures), dict(graphs.replays))
        want = ({name + ".conditions": 1, name + ".sample_step": 1},
                {name + ".conditions": TEMP_CALLS - 1,
                 name + ".sample_step": TEMP_CALLS * FS - 1})
        step = v._temp_steps[B]
        line = {"eager_ms_per_frame": float(np.median(eager_ms)),
                "graphed_ms_per_frame": float(np.median(graphed_ms[1:])),
                "first_call_ms": graphed_ms[0],
                "capture_s": step.capture_s, "same": same}
        out[(name, "graphed", B)] = line
        print(f"[graphs] {name} B={B} x {TEMP_CALLS} calls of 1 frame "
              f"carrying the state: bit-identical to the eager chain {same}; "
              f"eager {line['eager_ms_per_frame']:.1f} ms per frame, graphed "
              f"{line['graphed_ms_per_frame']:.2f} ms per frame "
              f"({np.median(eager_ms) / np.median(graphed_ms[1:]):.2f}x; "
              f"{FS} replays of the sample step a frame; host clock, "
              f"synchronised, median of {TEMP_CALLS} and "
              f"{TEMP_CALLS - 1} calls); the first call "
              f"{graphed_ms[0]:.1f} ms (an eager step, the step's capture "
              f"{step.capture_s:.3f} s, {FS - 2} replays); (captures, "
              f"replays) {got} [{card}]")
        if not same or got != want:
            raise RuntimeError(f"graphs: {name} B={B}: the graphed chain is "
                               f"not the eager one, or {got} is not {want}")
        del v, eager, graphed
    return out


def jit_site_cases(dev):
    """The other jit sites of phase 4l at the sizes their callers give
    them, each as (name, what, make): make() gives (the jit, the calls'
    arguments, carry(args, out) giving the next call's arguments from the
    last one's and its output or None, the generator or None)."""
    import torch
    from lpcnet_tpu_torch import data
    from lpcnet_tpu_torch import features as F
    from lpcnet_tpu_torch.cli import load_codebooks
    from lpcnet_tpu_torch.codec import codec, vq_train
    from lpcnet_tpu_torch.tools import eval_plc, fit_pade, train_codebooks
    from lpcnet_tpu_torch.training.optim import ScheduledAdam
    n = JIT_SITE_CALLS
    rs = np.random.RandomState(11)

    def dev_(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def pcm(B, frames):
        return dev_(rs.randn(B, frames * FS) * 3000)

    cases = []
    # (quantize, mode, streams, frames): the bench's features stage, the
    # encode command's chunk, dump-data test/btest's chunk
    for q, mode, B, T in ((False, "superframe", 128, 64),
                          (True, "superframe", 1, 64),
                          (False, "single", 1, 64)):
        def make(q=q, mode=mode, B=B, T=T):
            step = data.feature_step(q, mode)
            x = pcm(B, n * T)
            args = [(F.init_state(B, dev), x[:, i * T * FS:(i + 1) * T * FS])
                    for i in range(n)]
            return step, args, lambda a, o: (o[0], a[1]), None
        cases.append((data.feature_step(q, mode).name, f"B={B} x {T} frames",
                      make))
    cbs = load_codebooks(None, dev)
    # (kind, streams, superframes per call): the bench's codec stage,
    # train_codebooks' codec_rms
    for kind, B, S in (("encode_superframes", 128, 16),
                       ("decode_packets", 128, 16),
                       ("encode_superframe", 1, 1), ("decode_packet", 1, 1)):
        def make(kind=kind, B=B, S=S):
            step = data.codec_step(kind, cbs)
            _, f, sps = F.compute_features(F.init_state(B, dev),
                                           pcm(B, n * 4 * S),
                                           quantize_pitch=True)
            mem = torch.zeros((B, 18), device=dev)
            bufs = codec.encode_superframes(cbs, f, mem, sps)[0]
            args = []
            for i in range(n):
                sl = slice(i * S, (i + 1) * S)
                if kind == "encode_superframes":
                    args.append((f[:, 4 * sl.start:4 * sl.stop], mem,
                                 sps[sl]))
                elif kind == "encode_superframe":
                    args.append((f[:, 4 * i:4 * i + 4], mem, sps[i]))
                else:
                    args.append((bufs[:, sl] if S > 1 else bufs[:, i], mem))
            # vq_mem, the second argument, is the last call's last output
            return step, args, lambda a, o: a[:1] + (o[-1],) + a[2:], None
        cases.append((f"data.{kind}", f"B={B} x {S} superframes", make))

    # a pass at the codebooks' full sizes over a corpus of VQ_ROWS rows
    for multi, K in ((False, 1024), (True, 4096)):
        def make_vq(multi=multi, K=K):
            gen = torch.Generator(device=dev).manual_seed(0)
            x = dev_(rs.randn(*((VQ_ROWS, 4, 18) if multi
                                else (VQ_ROWS, 17))))
            cb = dev_(rs.randn(K, 18 if multi else 17))
            step = vq_train.multi_update if multi else vq_train.lloyd
            a0 = (cb, gen, x, True) if multi else (cb, gen, x)
            return step, [a0] * n, lambda a, o: (o,) + a[1:], gen
        cases.append(("vq_train.kmeans_multi.upd" if multi else
                      "vq_train.lloyd", f"{VQ_ROWS} rows, K={K}", make_vq))

    def make_pade():
        x, y, basis = fit_pade.grid(dev)
        p = fit_pade.seed_params(dev)
        opt = ScheduledAdam(lr=0.05, b1=0.9, b2=0.9)
        a0 = (p, opt.init(p), x, y, basis, 1.0, 0.0, opt)
        return fit_pade.fit_step, [a0] * n, lambda a, o: o + a[2:], None
    cases.append(("fit_pade.step", "the 2000-point grid", make_pade))

    def make_feats_of():
        x = pcm(16 * n, 200)
        return (train_codebooks.feats_of,
                [(x[16 * i:16 * (i + 1)],) for i in range(n)], None, None)
    cases.append(("train_codebooks.feats_of", "16 passes x 200 frames",
                  make_feats_of))

    def make_plc():
        from lpcnet_tpu_torch import convert
        p = convert.load_plc(device=dev)
        xs = dev_(rs.randn(n, 1, 200, 57) * 0.5)
        return eval_plc.forward, [(p, xs[i]) for i in range(n)], None, None
    cases.append(("eval_plc.forward", "B=1 x 200 frames", make_plc))
    return cases


def jit_site_lines(dev, card) -> dict:
    """Each case of jit_site_cases: JIT_SITE_CALLS calls under
    graphs.disabled(), each on what the last one left where the site
    carries a state, then the same chain graphed (the first call eager,
    the second captured, the others replays): every output, and the
    generator's final state, bit-identical; eager and replayed ms per call
    (host clock, synchronised; the median of the eager calls after the
    first and of the replays after the capture) and the capture's s.
    Raises RuntimeError on a failed check."""
    import torch
    from lpcnet_tpu_torch.utils import graphs
    out = {}
    for name, what, make in jit_site_cases(dev):
        step, args, carry, gen = make()
        step.clear()

        def run(ms):
            g0 = None if gen is None else gen.get_state()
            outs = []
            for i, a in enumerate(args):
                if i and carry is not None:
                    a = carry(a, outs[-1])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(step(*a))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            g1 = None if gen is None else gen.get_state()
            if gen is not None:
                gen.set_state(g0)
            return outs, g1

        eager_ms, graphed_ms = [], []
        with graphs.disabled():
            eager, gen_e = run(eager_ms)
        graphs.captures.clear()
        graphs.replays.clear()
        graphed, gen_g = run(graphed_ms)
        same = all(_same_tree(e, g) for e, g in zip(eager, graphed)) and (
            gen is None or torch.equal(gen_e, gen_g))
        got = (dict(graphs.captures), dict(graphs.replays))
        want = ({name: 1}, {name: len(args) - 1})
        line = {"eager_ms": float(np.median(eager_ms[1:])),
                "replay_ms": float(np.median(graphed_ms[2:])),
                "capture_call_s": graphed_ms[1] / 1e3,
                "capture_s": next(iter(step.steps.values())).capture_s,
                "same": same}
        out[(name, what, 0)] = line
        print(f"[graphs] {name} {what} x {len(args)} calls"
              f"{'' if carry is None else ' carrying the state'}: "
              f"bit-identical to the eager chain"
              f"{'' if gen is None else ' (the generator included)'} "
              f"{same}; eager {line['eager_ms']:.4f} ms, replay "
              f"{line['replay_ms']:.4f} ms per call "
              f"({line['eager_ms'] / line['replay_ms']:.2f}x; host clock, "
              f"synchronised, median of {len(args) - 1} and "
              f"{len(args) - 2}); the capturing call "
              f"{line['capture_call_s']:.3f} s (the capture "
              f"{line['capture_s']:.3f} s); (captures, replays) {got} "
              f"[{card}]")
        if not same or got != want:
            raise RuntimeError(f"graphs: {name} {what}: the graphed chain is "
                               f"not the eager one, or {got} is not {want}")
        step.clear()
    return out


def eval_phase(dev, card, zero_counts) -> dict:
    """Phase 4j eval: the port's evaluations and fits (lpcnet_tpu_torch/
    tools/) on the card with the shipped artifacts, each held against the
    port's CPU run of the same function with the tolerances of
    tests/test_torch_eval_tools.py: eval_lpcnet on the golden speech
    (counts set to 0 just before and read just after: K1 once per frame
    under plan L, trained and random init; the first EVAL_FRAMES frames of
    both on the same features against the CPU; the full length within
    EVAL_JAX_TOL of the JAX tool's numbers and well above random init),
    eval_plc on a btest file made by dump-data on the card, eval_dred at
    all 16 levels (EVAL_LEVELS against the CPU), train_codebooks into
    build/ (the shipped codebooks' stage and codec RMS against the CPU),
    fit_pade (the seed and a 20-step fit against the CPU). [eval] lines.
    Returns eval_lpcnet's launches."""
    import contextlib
    import io
    import tempfile
    import torch
    from lpcnet_tpu_torch import cli, convert, dred
    from lpcnet_tpu_torch.kernels import sample_cuda
    from lpcnet_tpu_torch.models import lpcnet as lpcnet_model
    from lpcnet_tpu_torch.tools import (eval_dred, eval_lpcnet, eval_plc,
                                        fit_pade, train_codebooks)
    ex = os.path.join(REPO, "examples")
    cpu = torch.device("cpu")
    pcm = np.fromfile(SPEECH, np.int16).astype(np.float32)

    def close(tag, a, b, atol=0.0, rtol=0.0):
        a, b = float(a), float(b)
        print(f"[eval] {tag}: card {a!r}, cpu {b!r}, |d| {abs(a - b):.3e} "
              f"(tolerance {atol or rtol}{' relative' if rtol else ''})")
        if not abs(a - b) <= atol + rtol * abs(b):
            raise RuntimeError(f"eval: {tag}: the card and the CPU differ "
                               f"beyond the tolerance")

    # eval_lpcnet
    ckpt = os.path.join(ex, "speech_lpcnet_params.bin")
    T = len(pcm) // FS // 4 * 4
    zero_counts()
    t0 = time.perf_counter()
    rows, ref_rms = eval_lpcnet.evaluate(ckpt, SPEECH, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(sample_cuda.launches)
    plans = dict(sample_cuda.plan_launches)
    print(f"[eval] eval_lpcnet: launches {launches}, by plan {plans} "
          f"({secs:.1f} s)")
    if launches["flat"] != 2 * T or sum(launches.values()) != 2 * T \
            or plans["L"] != 2 * T:
        raise RuntimeError(f"eval_lpcnet: expected {2 * T} flat launches "
                           f"under plan L")
    for name, (ac, sp, rms) in rows:
        print(f"[eval] eval_lpcnet {name}, {T} frames: pitch-lag autocorr "
              f"{ac:+.4f}, log-spec corr {sp:.4f}, rms {rms:.1f} (ref rms "
              f"{ref_rms:.1f}); the JAX tool on the CPU, shipped: "
              f"{EVAL_JAX[0]:+.3f}, {EVAL_JAX[1]:.3f}, {EVAL_JAX[2]:.0f} "
              f"[{card}]")
    (ac, sp, rms), (rac, rsp, rrms) = rows[0][1], rows[1][1]
    if not (abs(ac - EVAL_JAX[0]) <= EVAL_JAX_TOL[0]
            and abs(sp - EVAL_JAX[1]) <= EVAL_JAX_TOL[1]
            and abs(rms - EVAL_JAX[2]) <= EVAL_JAX_TOL[2] * EVAL_JAX[2]):
        raise RuntimeError(f"eval_lpcnet: the shipped vocoder on the card "
                           f"is not within {EVAL_JAX_TOL} of the JAX tool")
    if not (ac > rac + 0.5 and sp > rsp and rms < 0.5 * rrms):
        raise RuntimeError("eval_lpcnet: not well above random init")
    feats = eval_lpcnet.speech_features(pcm, dev)[:, :EVAL_FRAMES].cpu()
    cfg = lpcnet_model.LPCNetConfig()
    for name, p in (("trained", convert.load_lpcnet(ckpt, cpu)),
                    ("random init", lpcnet_model.init_params(
                        torch.Generator().manual_seed(0), cfg))):
        a = eval_lpcnet.synth_stats(p, cfg, feats, pcm, EVAL_FRAMES, dev)
        b = eval_lpcnet.synth_stats(p, cfg, feats, pcm, EVAL_FRAMES, cpu)
        tag = f"eval_lpcnet {name}, first {EVAL_FRAMES} frames"
        close(f"{tag}, autocorr", a[0], b[0], atol=EVAL_TOL["autocorr"])
        close(f"{tag}, log-spec corr", a[1], b[1], atol=EVAL_TOL["logspec"])
        close(f"{tag}, rms", a[2], b[2], rtol=EVAL_TOL["rms_rel"])

    # eval_plc
    ckpt = os.path.join(ex, "speech_plc_params.bin")
    with tempfile.TemporaryDirectory() as tmp:
        btest = os.path.join(tmp, "speech_btest.f32")
        if cli.main(["dump-data", "btest", SPEECH, btest, "--device",
                     str(dev)]) not in (0, None):
            raise RuntimeError("eval_plc: dump-data btest failed")
        n_lost, n, r = eval_plc.evaluate(ckpt, btest, device=dev)
        _, _, r_cpu = eval_plc.evaluate(ckpt, btest, device=cpu)
    print(f"[eval] eval_plc: lost frames {n_lost}/{n} at rate 0.25; feature "
          f"L1 on lost frames: trained {r['trained']:.4f}, predict-zero "
          f"{r['predict-zero']:.4f}, random init {r['random init']:.4f} "
          f"[{card}]")
    for k in r:
        close(f"eval_plc {k} L1", r[k], r_cpu[k], atol=EVAL_TOL["plc_l1"])

    # eval_dred
    ckpt = os.path.join(ex, "speech_dred_params.bin")
    t0 = time.perf_counter()
    table = eval_dred.evaluate(ckpt, [("speech", FEATS)], tuple(range(16)),
                               device=dev, verbose=False)
    src = table["sources"]["speech"]
    print(f"[eval] eval_dred ({time.perf_counter() - t0:.1f} s), "
          f"{src['frames']} frames: {json.dumps(src['levels'])} [{card}]")
    params_d, cfg_d = convert.load_dred(ckpt, dev)
    params_c, _ = convert.load_dred(ckpt, cpu)
    f = torch.as_tensor(cli.read_features(FEATS)[-src["frames"]:, :20][None])
    for lv in EVAL_LEVELS:
        a = dred.roundtrip(params_d, cfg_d, f.to(dev), lv)
        b = dred.roundtrip(params_c, cfg_d, f, lv)
        close(f"eval_dred q{lv} rms", a[0], b[0], rtol=EVAL_TOL["dred_rel"])
        close(f"eval_dred q{lv} bits", a[1], b[1], rtol=EVAL_TOL["dred_rel"])

    # train_codebooks, into build/
    out = os.path.join(REPO, "build", "chip_smoke", "codec_codebooks.bin")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_codebooks.main(CODEBOOK_ARGS + ["--out", out, "--device",
                                              str(dev)])
    with open(out + ".json") as fh:
        rep = json.load(fh)
    print(f"[eval] train_codebooks {' '.join(CODEBOOK_ARGS)} "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(rep)} [{card}]")
    if not rep["held_stage3_rms"] < rep["rand_stage3_rms"]:
        raise RuntimeError("train_codebooks: no better than random")
    cbs = {k: v.numpy() for k, v in cli.load_codebooks(None, cpu).items()}
    with contextlib.redirect_stdout(io.StringIO()):
        held = train_codebooks.build_corpus(pcm, 2, 100003, dev)
    a = train_codebooks.stage_rms(held, cbs, dev)
    b = train_codebooks.stage_rms(held, cbs, cpu)
    for k in a:
        close(f"train_codebooks shipped {k}", a[k], b[k],
              atol=EVAL_TOL["vq_rms"])
    close("train_codebooks shipped codec_rms",
          train_codebooks.codec_rms(pcm, cbs, dev),
          train_codebooks.codec_rms(pcm, cbs, cpu), atol=EVAL_TOL["vq_rms"])

    # fit_pade
    t0 = time.perf_counter()
    coeffs, emax, emean = fit_pade.fit(PADE_STEPS, verbose=False, device=dev)
    print(f"[eval] fit_pade {PADE_STEPS} steps per stage "
          f"({time.perf_counter() - t0:.1f} s): num {coeffs['num']}, den "
          f"{coeffs['den']}, max |err| {emax:.4e}, mean |err| {emean:.4e} "
          f"[{card}]")
    seed = []
    for d in (dev, cpu):
        x, y, basis = fit_pade.grid(d)
        e = (fit_pade.predict(fit_pade.seed_params(d), x, basis) - y).abs()
        seed.append((float(e.max()), float(e.mean())))
    close("fit_pade seed max |err|", seed[0][0], seed[1][0],
          atol=EVAL_TOL["pade_seed"])
    close("fit_pade seed mean |err|", seed[0][1], seed[1][1],
          atol=EVAL_TOL["pade_seed"])
    if not emax < seed[0][0]:
        raise RuntimeError("fit_pade: the fit is no better than its seed")
    a = fit_pade.fit(20, verbose=False, device=dev)
    b = fit_pade.fit(20, verbose=False, device=cpu)
    for k in ("num", "den"):
        for i, (u, w) in enumerate(zip(a[0][k], b[0][k])):
            close(f"fit_pade 20 steps {k}[{i}]", u, w,
                  rtol=EVAL_TOL["pade_coef_rel"])
    close("fit_pade 20 steps max |err|", a[1], b[1],
          rtol=EVAL_TOL["pade_err_rel"])
    close("fit_pade 20 steps mean |err|", a[2], b[2],
          rtol=EVAL_TOL["pade_err_rel"])
    return {"launches": launches["flat"]}


def print_phases(sample_cuda, v, card, cases, teacher=False) -> None:
    """[phases] lines: the phase-split instance of the frame kernel, or of
    K4 (teacher: 160 forced samples of the golden speech), on (plan, batch)
    cases, the plan forced through the cluster count that launch_plan
    reads; us per step for each phase, by the SM clock of the first CTA's
    loop. Beside them, us per step of the whole launch of the same kernel
    without stamps on the same inputs by CUDA events: the stamps' own cost.
    (The stamping instance reads its stamps back after every launch, so
    events around it would time the host too.)"""
    import torch
    for plan, B in cases:
        conds = v.conditions(tiled_features(B, 2))
        st = v.reset(B, per_stream_rng=True)
        cond = {k: conds[k][:, 1].contiguous()
                for k in ("cond_a", "cond_b", "lpc")}
        target = torch.as_tensor(tiled_speech(B, 1), device=v.device) \
            if teacher else None
        with sample_cuda._plan_forced(v.device, plan):
            for _ in range(2):                         # the second counts
                ph = sample_cuda.phase_split(v.tables, st, cond, v.cfg,
                                             target=target)
            if teacher:
                plain = cuda_ms(lambda: sample_cuda.teacher_advance(
                    v.tables, st, cond, v.cfg, target), 3)
            else:
                plain = cuda_ms(lambda: sample_cuda.synthesize_frame(
                    v.tables, st, cond["cond_a"], cond["cond_b"],
                    cond["lpc"], v.cfg), 3)
        torch.cuda.synchronize()
        if ph["plan"] != plan or sample_cuda.last_plan[0] != plan:
            raise RuntimeError(f"phases: plan {ph['plan']}, not {plan}")
        what = "teacher_advance" if teacher else "frame kernel"
        print(f"[phases] {what} plan {plan} (cluster {ph['cluster']}) B={B}: "
              + ", ".join(f"{k} {ph[k]:.3f}"
                          for k in sample_cuda.PHASES + ("step",))
              + f" us per step (SM clock {ph['clock_ghz']:.3f} GHz); "
              f"{what} by CUDA events, launch / {FS}: "
              f"{plain * 1e3 / FS:.3f} [{card}]")


if __name__ == "__main__":
    sys.exit(main())
