"""lpcbench: the benchmark of lpcnet_tpu_torch, the PyTorch and CUDA port.

    python3 lpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the root of the repo names the cells (workloads); each
cell names a configuration (configs/<name>.json), a traffic mix
(traffic/<name>.json, whose "driver" names drivers/<driver>.py) and has
its correctness limits in limits/<workload>.json. Each per-layer metric is
metrics/<name>.py. The harness finds every one of them by name, so a new
cell, mix or metric is a new file. The plain reference that decides
`correct` is reference/; it imports nothing of the port.
"""
