"""Where the graphed LPCNet training step spends the card's time.

    python3 tools/train_step_trace.py [--batch 32] [--frames 15]

Runs lpcnet_task.train_step at LPCNetConfig() (seed-0 random init) on
random seeded windows of batch x frames x 160 samples with a noise
generator: the first step eagerly, the second captured as a CUDA graph
and replayed (utils/graphs.py), then times 3 replays (host clock,
synchronised) and traces one more on the card alone
(utils/profiling.trace, cpu=False). Prints the replay's ms, the trace's
device occupancy and busy us, and the busy us of the kernels with the
most, summed by operation (the innermost functor of PyTorch's
elementwise kernels, else the kernel's name). Needs a card; the card's
name and power limit come first.
"""
import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, REPO)

from lpcnet_tpu_torch import convert  # noqa: E402
from lpcnet_tpu_torch.models import lpcnet  # noqa: E402
from lpcnet_tpu_torch.training import lpcnet_task  # noqa: E402
from lpcnet_tpu_torch.utils import graphs, profiling  # noqa: E402


def kernel_op(name: str) -> str:
    """The operation of a PyTorch elementwise kernel's name (its innermost
    functor, or the copy), else the name without arguments."""
    ops = re.findall(r"\w*Functor\w*|direct_copy_kernel_cuda", name)
    return ops[-1] if ops else name.split("(")[0].replace("void ", "")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_trace: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = lpcnet.LPCNetConfig()
    B, T = args.batch, args.frames
    S = T * cfg.frame_size
    rs = np.random.RandomState(5)

    def f32(x):
        return torch.as_tensor(x.astype(np.float32), device=dev)

    batch = {"sig_in": f32(rs.randn(B, S) * 3000),
             "sig_out": f32(rs.randn(B, S) * 3000),
             "features": f32(rs.randn(B, T + 4, 20) * .3),
             "periods": torch.as_tensor(rs.randint(33, 255, (B, T + 4)),
                                        dtype=torch.int32, device=dev),
             "lpc": f32(rs.randn(B, T, 16) * .1)}
    params = convert.to_device(
        lpcnet.init_params(torch.Generator().manual_seed(0), cfg), dev)
    opt = lpcnet_task.make_optimizer()
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        return lpcnet_task.train_step(params, state, batch, cfg, opt, gen)

    for _ in range(graphs.CAPTURE_CALL):       # eager, then captured
        step()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / 3
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, cpu=False):
            step()
            torch.cuda.synchronize(dev)
        u = profiling.parse_trace_utilization(d) or {}
    ops = collections.Counter()
    for name, us in (u.get("busy_us_by_class") or {}).items():
        ops[kernel_op(name)] += us
    name = lpcnet_task.train_step.name
    print(f"train step LPCNetConfig() {B} x {S}: {graphs.captures[name]} "
          f"capture, {graphs.replays[name]} replays; replayed "
          f"{ms:.1f} ms per step ({B * S / ms * 1e3:.0f} training samples "
          f"per s, mean of 3); one traced replay (device alone): occupancy "
          f"{u.get('device_occupancy')}, busy {u.get('busy_us')} of "
          f"{u.get('span_us')} us; busy us of the six kernels with the "
          f"most, by operation {dict(ops)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
