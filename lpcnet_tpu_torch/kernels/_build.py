"""Builds the port's CUDA sources (lpcnet_tpu_torch/csrc/*.cu) with nvcc into
shared libraries with a plain C interface, loaded with ctypes.

A library lands in build/lpcnet_tpu_torch/ at the root of the checkout,
named after its source and a hash of the source, of every csrc/ header it
includes and of the flags, so a changed source or header builds anew and an
unchanged one is reused. Only a machine with the
CUDA toolkit and a card builds; nothing here runs at import time.

Flags: sm_90a code, -O3, no fast math, and --fmad=false, so that nvcc
does not contract a*b+c into an FMA: the mu-law polynomial, the GRU gates
and the de-emphasis chain round each operation as the plain version does.
"""
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "lpcnet_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME), else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> List[str]:
    """csrc/<name>.cu and every file under csrc/ that it includes with
    quotes, directly or through another such file."""
    files, todo = [], [name + ".cu"]
    while todo:
        rel = todo.pop()
        path = os.path.join(CSRC_DIR, rel)
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return files


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no library yet, one nvcc process
    per source, all started together. Returns {name: compiler output}
    ("" for a library that was already built). Raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            logs[name] = ""
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
        logs[name] = f"{out}built {name} in {time.perf_counter() - t0:.1f} s"
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu (built on first use)."""
    build([name])
    return ctypes.CDLL(library_path(name))
