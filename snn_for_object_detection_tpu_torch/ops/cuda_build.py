"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled at first
use into its own shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``). The library's file name
carries a hash of the source and the flags, so an edited source is
never served from a stale build. Nothing here runs when the module is
imported: CPU-only installs never need ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "kernels",
)
# sm_90a: Hopper. --fmad=false keeps every fp32 multiply and add
# rounded on its own unless the source asks for a fused one
# (__fmaf_rn), so the kernels round where their plain versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(source: str) -> str:
    # the hash covers the shared headers (csrc/*.cuh) a source includes
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(
        f for f in os.listdir(CSRC) if f.endswith(".cuh")
    ):
        with open(os.path.join(CSRC, path), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(sources: Iterable[str]) -> Dict[str, float]:
    """Compile every source that has no current build, all ``nvcc``
    processes at once. Returns the seconds each compile took (sources
    already built are left out). Raises with the compiler's output if
    one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sources:
        out = _target(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (time.perf_counter(), tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    seconds = {}
    failures = []
    for src, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {src} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source, built if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(_target(source))
            _libs[source] = lib
        return lib
