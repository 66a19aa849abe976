"""Run one cell of the benchmark on the card and print its result line.

    python3 lpcbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is the
result (correct, attempted, failed, metrics, device, with --trace 1 a
breakdown, and last the compared numbers beside their limits); the last
lines of standard error are those numbers again. Exits with a code other
than 0, printing no result, where there is no CUDA device, fewer cards
than the cell asks for, or a module of JAX or the JAX package loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lpcbench import harness  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.report(harness.run(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START))


if __name__ == "__main__":
    main()
