"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``build/`` at the repository root, named by a hash of its source, so an
edited source rebuilds and an unchanged one loads at once.  Nothing is
built when this module is imported: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def start_build(name: str):
    """Start compiling ``csrc/<name>.cu`` unless its library exists;
    returns ``(nvcc process, temporary output, library path)``, or None
    when there is nothing to build.  Several sources build in parallel by
    starting them all first."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(started) -> str:
    """Wait for a build from ``start_build``; returns the compiler's output
    (registers, shared memory and spills per kernel)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        finish_build(start_build(name))
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def build_all(names=("segment_agg", "ssd_scan", "decode_attn")
              ) -> tuple[float, str]:
    """Build every named source in parallel and load each; returns the
    wall seconds taken and the compilers' output."""
    t0 = time.perf_counter()
    procs = [start_build(n) for n in names]
    logs = [finish_build(p) for p in procs]
    for n in names:
        load(n)
    return time.perf_counter() - t0, "\n".join(logs)
