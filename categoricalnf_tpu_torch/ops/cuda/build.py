"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface, ``_build/<name>-<hash>.so`` beside the package (the
directory is git-ignored).  The hash covers the source, every header of
``csrc/`` and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.  Nothing here runs
at import time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# No --use_fast_math: the CDF math needs IEEE expf/logf/log1pf.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu``'s library is (or will be) built."""
    return _target(name)[1]


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process or None, tmp_path, so_path)``."""
    src, so = _target(name)
    if os.path.exists(so):
        return None, None, so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    log = open(f"{so}.log", "w")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, so


def _finish(name: str, proc, tmp, so) -> None:
    if proc is None:
        return
    if proc.wait() != 0:
        with open(f"{so}.log") as f:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{f.read()}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def build_all(names) -> dict[str, str]:
    """Compile several sources at once, one nvcc each, started together.
    Returns each name's nvcc log (registers, shared memory, spills)."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        try:
            for n, proc, tmp, so in started:
                _finish(n, proc, tmp, so)
        finally:
            for _, proc, _, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    logs = {}
    for n in names:
        _, so = _target(n)
        path = f"{so}.log"
        logs[n] = open(path).read() if os.path.exists(path) else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc, tmp, so = _start(name)
            _finish(name, proc, tmp, so)
            lib = _libs[name] = ctypes.CDLL(so)
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")
