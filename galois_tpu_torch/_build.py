"""Build the port's CUDA C++ sources with nvcc at first use; load with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, alone, into
``build/galois_tpu_torch/lib<name>-<hash>.so`` beside the package (the hash
covers the sources and flags, so an edited source is rebuilt). Nothing is
compiled when a module is imported; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "galois_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills into BUILD_LOGS
]

# nvcc's output per library built in this process (ptxas resource usage).
BUILD_LOGS: dict = {}

_LOCK = threading.Lock()
_LOCKS: dict = {}  # one per source, so that different sources build in parallel
_LIBS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: galois_tpu_torch's CUDA kernels need the CUDA toolkit.")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    Threads may build different sources at once."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in [src, *sorted(CSRC.glob("*.cuh"))]:
            digest.update(f.read_bytes())
        lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
            )
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{BUILD_LOGS[name]}")
            os.replace(tmp, lib_path)
        _LIBS[name] = ctypes.CDLL(str(lib_path))
        return _LIBS[name]
