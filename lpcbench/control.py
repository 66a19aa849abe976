"""Readings of a cell's compared numbers over many seeds, in one process:
the program's (sound runs), its control's (the cell's lower-precision
control in the program's place) and the program's with a fault planted
(faults.py), from which the limits in limits/<workload>.json are set.

    python3 -m lpcbench.control --workload <name> --seeds 1,2,3 \
        --seconds <s> [--control 0|1|both] [--fault unchanged|token|half]

Prints one JSON line per run: the seed, the control or the fault, each
compared number and `correct` under the limits as they stand.
"""
import contextlib
import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional

from lpcbench import faults, harness


def readings(workload: str, seeds: Iterable[int], seconds: float,
             control: bool, device=None, overrides=None,
             fault: Optional[str] = None) -> List[Dict]:
    out = []
    for seed in seeds:
        line = {"workload": workload, "seed": seed, "control": control,
                "fault": fault}
        with faults.plant(fault) if fault else contextlib.nullcontext():
            res = harness.run(workload, seed, seconds, False, device=device,
                              control=control, overrides=overrides)
        line.update(correct=res["correct"],
                    numbers={k: c["value"] for k, c in res["checks"].items()},
                    metrics={k: m["value"] for k, m in res["metrics"].items()})
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=("0", "1", "both"), default="both")
    ap.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for control in {"0": [False], "1": [True],
                    "both": [False, True]}[args.control]:
        readings(args.workload, seeds, args.seconds, control,
                 fault=args.fault)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
