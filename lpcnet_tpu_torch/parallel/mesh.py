"""Stream- and data-parallel work over torch.distributed (the port of
lpcnet_tpu/parallel/mesh.py).

The LPCNet family is small (a few MB of weights), so its parallelism is
pure stream/data parallelism: every rank holds the whole model and one
contiguous block of the streams or of the training batch. The JAX
package's 1-D "dp" mesh becomes a process group of one process per rank,
set up from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), NCCL between cards and gloo on the CPU:

  * shard_synthesis: rank r synthesizes streams [r*b, (r+1)*b) with those
    streams' own per-stream seeds, so that the waveform does not depend on
    the world size. Synthesis needs no collective; gathering the pcm onto
    rank 0 is an option.
  * dp_train_step: the LPCNet train step on a data-parallel batch. The
    trainers are functional (value_and_grad over parameter trees), so there
    is no DDP: the gradient leaves are summed over the ranks as one
    flattened buffer and divided by the world size, and every rank applies
    the same Adam update. The training noise is drawn for the whole batch
    and each rank keeps its rows, so the step is the single-process step
    on the whole batch.
  * spawn: runs a function in one new process per rank, with the
    environment torchrun would set and a time limit; each process tears
    its process group down on every exit path. dryrun_training_step and
    dryrun_inference_stream_dp drive it.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU.
NCCL takes one rank per card; two ranks on one card take gloo
(backend="gloo"), whose collectives on CUDA tensors copy them through host
memory inside the collective itself (torch's ProcessGroupGloo).

    torchrun --nproc_per_node=N script.py    # script: init_dp(), then
                                             # shard_synthesis(...)
"""
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..constants import FRAME_SIZE, NB_TOTAL_FEATURES
from ..device import resolve_device
from ..kernels import sample_scan
from ..ops import kiss99
from ..training import lpcnet_task
from ..training.optim import tree_leaves, tree_map, tree_unflatten, \
    value_and_grad
from ..utils import graphs

PG_TIMEOUT_S = 300     # a collective waits this long for a dead peer
MODULE = "lpcnet_tpu_torch.parallel.mesh"
INFERENCE_FRAMES = 2   # frames of dryrun_inference_stream_dp


def init_dp(backend: Optional[str] = None, device=None
            ) -> Tuple[int, int, torch.device]:
    """Join the process group that torchrun's environment names (the
    counterpart of make_mesh). device: None means cuda:LOCAL_RANK, and
    raises where there is no card; backend: None means NCCL on a CUDA
    device and gloo on the CPU. Returns (rank, world size, device)."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"init_dp needs {', '.join(missing)} in the "
                           f"environment (torchrun sets them)")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
        f"{env['MASTER_PORT']}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return rank, world, dev


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rows(n: int, rank: int, world: int, what: str = "leading axis"
          ) -> slice:
    if n % world:
        raise ValueError(f"{what} {n} must divide over {world} ranks")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def shard_batch(tree, rank: int, world: int):
    """Each leaf's leading axis cut into `world` contiguous blocks; rank r
    keeps block r (batch_sharding / shard_batch). Leaves are tensors or
    numpy arrays, nested in dicts."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, rank, world) for k, v in tree.items()}
    return tree[_rows(tree.shape[0], rank, world)]


def replicate(tree):
    """Every tensor leaf overwritten in place by rank 0's (a broadcast per
    leaf, in tree_leaves order); returns tree."""
    if rank_world()[1] > 1:
        for t in tree_leaves(tree):
            dist.broadcast(t, 0)
    return tree


def gather_rows(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The ranks' x concatenated along the rows in rank order, on rank 0;
    None on the other ranks."""
    rank, world = rank_world()
    if world == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(x, parts, dst=0)
    return torch.cat(parts) if rank == 0 else None


def shard_synthesis(voc, batch: int, gather: bool = False):
    """Stream-parallel synthesis: (state, synth_fn) for this rank's block
    of `batch` streams (the JAX package's shard_synthesis).

    The state holds rows [r*b, (r+1)*b) of the whole batch's per-stream
    seeds (kiss99.batched_seed(batch, per_stream=True)), so stream i gets
    stream i's seed whatever the world size. synth_fn(state, features)
    takes the whole batch's features (B, T, 36), numpy or a tensor, keeps
    this rank's rows and runs voc.synthesize on them (on the card, the
    frame kernel over the rank's streams). It returns (state, pcm): this
    rank's pcm (b, T*160), or with gather=True the whole batch's pcm on
    rank 0 and None on the others."""
    rank, world = rank_world()
    rows = _rows(batch, rank, world, "batch")
    seeds = kiss99.batched_seed(batch, per_stream=True)[rows]
    state = sample_scan.init_state(rows.stop - rows.start, voc.cfg, seeds,
                                   voc.device)

    def synth_fn(state, features):
        if len(features) != batch:
            raise ValueError(f"features of {len(features)} streams for a "
                             f"batch of {batch}")
        state, pcm = voc.synthesize(state, features[rows])
        return state, gather_rows(pcm) if gather else pcm

    return state, synth_fn


def global_noise(gen: torch.Generator, local_shape, cfg, rank: int,
                 world: int) -> Dict[str, torch.Tensor]:
    """The training noise of the whole batch, drawn from gen as
    lpcnet_task.forward draws it (cpcm (B, S, 3), then GRU-A's output
    (B, S, gru_a_units)), and this rank's rows of it. With gen seeded
    alike on every rank, the ranks' rows together are the single-process
    draws."""
    b, s = local_shape
    kw = dict(generator=gen, dtype=torch.float32, device=gen.device)
    cpcm = torch.randn((b * world, s, 3), **kw)
    gru_a = torch.randn((b * world, s, cfg.gru_a_units), **kw)
    rows = slice(rank * b, (rank + 1) * b)
    return {"cpcm": cpcm[rows], "gru_a": gru_a[rows]}


def _dp_train_step(params, opt_state, local_batch, cfg, opt, noise=None):
    rank, world = rank_world()
    if isinstance(noise, torch.Generator):
        noise = global_noise(noise, local_batch["sig_in"].shape, cfg, rank,
                             world)
    (_, metrics), grads = value_and_grad(
        lambda p: lpcnet_task.loss_fn(p, local_batch, cfg, noise), params)
    if dist.is_available() and dist.is_initialized():
        # in a group of one too: a sum over one rank divided by 1 keeps
        # the bits, and the graph holds the collective all the same
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in leaves])
        dist.all_reduce(flat)
        flat /= world
        grads = tree_unflatten(grads, [c.view_as(g) for c, g in zip(
            torch.split(flat, [g.numel() for g in leaves]), leaves)])
        names = sorted(metrics)
        m = torch.stack([metrics[k] for k in names])
        dist.all_reduce(m)
        m /= world
        metrics = dict(zip(names, m.unbind()))
    params, opt_state = opt.apply(params, grads, opt_state)
    with torch.no_grad():
        params = lpcnet_task.weight_clip(params)
    return params, opt_state, metrics


# the counterpart of JAX's jitted train_step over the dp mesh
# (lpcnet_tpu/parallel/mesh.py:66-110), the all-reduce inside the program:
# captured with capture_error_mode="thread_local", since the process
# group's watchdog thread may make CUDA calls while a rank captures
_dp_step = graphs.jit(_dp_train_step, "mesh.dp_train_step",
                      capture_error_mode="thread_local")


def dp_train_step(params, opt_state, local_batch, cfg, opt, noise=None):
    """One LPCNet train step on a data-parallel batch (lpcnet_task.
    train_step on the whole batch): this rank's loss and gradients on its
    rows, the gradients averaged over the ranks (one flattened buffer,
    all-reduced and divided by the world size), the same Adam update and
    weight clip on every rank. noise: as lpcnet_task's; a generator (seeded
    alike on every rank) draws the whole batch's noise (global_noise).
    Returns (params, opt_state, metrics averaged over the ranks).

    A jit entry point ("mesh.dp_train_step"): over NCCL (and with no
    process group) the first step of a signature runs eagerly, which also
    makes NCCL's communicator before any capture, the second is captured
    with both all-reduces, the loss, the gradients, Adam, the weight clip
    and the noise generator inside, and later steps replay it on every
    rank in step. A gloo collective copies through the host and cannot be
    captured, so in a gloo group every step runs eagerly."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_backend() != "nccl":
        with graphs.disabled():
            return _dp_step(params, opt_state, local_batch, cfg, opt, noise)
    return _dp_step(params, opt_state, local_batch, cfg, opt, noise)


# ---------------------------------------------------------------- processes

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(procs, timeout: float) -> str:
    """'ok' when every process exited 0, 'failed' as soon as one exits
    otherwise, 'timeout' after timeout seconds."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            return "failed"
        if all(c == 0 for c in codes):
            return "ok"
        if time.monotonic() > deadline:
            return "timeout"
        time.sleep(0.05)


def spawn(target: str, world: int, devices: Optional[Sequence] = None,
          backend: Optional[str] = None, args: Sequence = (),
          timeout: float = 600.0, pythonpath: Sequence[str] = ()
          ) -> List[Any]:
    """Run target ('module:function') in `world` new processes, as torchrun
    would start them on this host: rank r joins the process group through
    init_dp(backend, devices[r]) (devices: None means cuda:r), calls
    function(rank, world, device, *args) and returns its value through a
    file (tensors, numbers, strings, lists and dicts). The target module
    is imported from this package's checkout or `pythonpath`; the
    processes inherit this one's environment. Every process is killed when
    one fails or after
    `timeout` seconds, and the call raises RuntimeError with the end of
    each rank's output. Returns the values by rank."""
    devices = ([f"cuda:{r}" for r in range(world)] if devices is None
               else [str(d) for d in devices])
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = [str(p) for p in pythonpath] + [root]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        try:
            for r in range(world):
                renv = dict(os.environ, RANK=str(r),
                            WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                            MASTER_ADDR="localhost", MASTER_PORT=str(port),
                            PYTHONPATH=os.pathsep.join(path))
                logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", MODULE, target, devices[r],
                     backend or "", os.path.join(tmp, f"rank{r}.pt"),
                     json.dumps(list(args))],
                    env=renv, stdout=logs[-1], stderr=subprocess.STDOUT))
            status = _wait(procs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            text = []
            for log in logs:
                log.seek(0)
                text.append(log.read())
                log.close()
        if status != "ok":
            tails = "\n".join(
                f"--- rank {r} (exit {p.returncode}):\n{t[-3000:]}"
                for r, (p, t) in enumerate(zip(procs, text)))
            raise RuntimeError(f"{target} over {world} ranks: {status} "
                               f"(time limit {timeout} s)\n{tails}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(world)]


def _worker(argv: Sequence[str]) -> None:
    """One rank of spawn: join the group, run the target, save its value;
    the group is torn down on every exit path."""
    target, device, backend, out, args = argv
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    rank, world, dev = init_dp(backend or None, device)
    try:
        torch.save(fn(rank, world, dev, *json.loads(args)), out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ dry runs

def dryrun_batch(batch: int, frames: int, cfg) -> Dict[str, np.ndarray]:
    """The dry run's training batch from RandomState(0) (the JAX package's
    dryrun_training_step)."""
    S = frames * cfg.frame_size
    rs = np.random.RandomState(0)
    return {
        "sig_in": rs.randn(batch, S).astype(np.float32) * 1000,
        "sig_out": rs.randn(batch, S).astype(np.float32) * 1000,
        "features": rs.randn(batch, frames + 4, 20).astype(np.float32) * 0.3,
        "periods": rs.randint(33, 255, (batch, frames + 4)).astype(np.int32),
        "lpc": rs.randn(batch, frames, 16).astype(np.float32) * 0.1,
    }


def dryrun_setup(device):
    """(cfg, params, optimizer, its state, noise generator) of the dry
    run's step: LPCNetConfig(), parameters from init_params of a generator
    seeded 0, the reference's Adam, noise seeded 1."""
    from ..models import lpcnet
    cfg = lpcnet.LPCNetConfig()
    params = convert.to_device(
        lpcnet.init_params(torch.Generator().manual_seed(0), cfg), device)
    opt = lpcnet_task.make_optimizer()
    noise = torch.Generator(device=device).manual_seed(1)
    return cfg, params, opt, opt.init(params), noise


def train_rank(rank: int, world: int, device, frames: int = 3
               ) -> Dict[str, Any]:
    """One rank of dryrun_training_step: the flagship LPCNet train step on
    this rank's rows of a batch of 2 x world, parameters replicated from
    rank 0. Returns the loss, the step's ms (host clock, synchronised) and
    the updated parameters on the CPU."""
    cfg, params, opt, opt_state, noise = dryrun_setup(device)
    params = replicate(params)
    local = {k: torch.as_tensor(v, device=device) for k, v in shard_batch(
        dryrun_batch(2 * world, frames, cfg), rank, world).items()}
    t0 = time.perf_counter()
    params, opt_state, metrics = dp_train_step(params, opt_state, local,
                                               cfg, opt, noise)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"loss": float(metrics["loss"]),
            "ms": (time.perf_counter() - t0) * 1e3,
            "params": tree_map(lambda p: p.detach().cpu(), params)}


def dryrun_training_step(n: int, device=None, backend: Optional[str] = None,
                         frames: int = 3, timeout: float = 600.0
                         ) -> List[Dict[str, Any]]:
    """The flagship LPCNet train step (LPCNetConfig(), B = 2n, T = frames)
    over n ranks (train_rank in spawned processes; device None: rank r on
    cuda:r). Raises RuntimeError unless the loss is finite and every rank
    holds rank 0's parameters exactly. Returns each rank's train_rank
    value."""
    out = spawn(f"{MODULE}:train_rank", n,
                None if device is None else [device] * n, backend,
                [frames], timeout)
    if not np.isfinite(out[0]["loss"]):
        raise RuntimeError(f"dp training step: loss {out[0]['loss']}")
    ref = tree_leaves(out[0]["params"])
    for r, o in enumerate(out[1:], 1):
        if not all(torch.equal(a, b) for a, b in
                   zip(ref, tree_leaves(o["params"]))):
            raise RuntimeError(f"dp training step: rank {r}'s parameters "
                               f"differ from rank 0's")
    return out


def inference_rank(rank: int, world: int, device) -> Dict[str, Any]:
    """One rank of dryrun_inference_stream_dp: shard_synthesis of 2 x world
    streams of random features (RandomState(0)) with the shipped weights;
    this rank's pcm shape and finiteness, and rank 0's gathered shape."""
    from ..vocoder import Synthesizer
    voc = Synthesizer(device=device)
    B = 2 * world
    state, synth_fn = shard_synthesis(voc, B)
    feats = np.random.RandomState(0).randn(
        B, INFERENCE_FRAMES, NB_TOTAL_FEATURES).astype(np.float32) * 0.1
    state, pcm = synth_fn(state, feats)
    full = gather_rows(pcm)
    return {"shape": list(pcm.shape),
            "finite": bool(torch.isfinite(pcm).all()),
            "gathered": None if full is None else list(full.shape)}


def dryrun_inference_stream_dp(n: int, device=None,
                               backend: Optional[str] = None,
                               timeout: float = 600.0
                               ) -> List[Dict[str, Any]]:
    """Stream-parallel synthesis at LPCNetConfig() over n ranks (B = 2n,
    T = INFERENCE_FRAMES; device None: rank r on cuda:r): raises
    RuntimeError unless every rank synthesized its B/n rows, finite, and
    rank 0 gathered (B, T*160). Returns each rank's inference_rank
    value."""
    out = spawn(f"{MODULE}:inference_rank", n,
                None if device is None else [device] * n, backend,
                timeout=timeout)
    B, S = 2 * n, INFERENCE_FRAMES * FRAME_SIZE
    for r, o in enumerate(out):
        if o["shape"] != [B // n, S] or not o["finite"]:
            raise RuntimeError(f"dp synthesis: rank {r} gave {o}")
    if out[0]["gathered"] != [B, S]:
        raise RuntimeError(f"dp synthesis: gathered {out[0]['gathered']}")
    return out


if __name__ == "__main__":
    _worker(sys.argv[1:])
