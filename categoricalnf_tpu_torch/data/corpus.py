"""ctypes wrappers of the host data generators in ``corpus.cpp``: the set
tasks' permutations and sum-constrained sequences, the language-modeling
corpora and their crops (counterpart of
``categoricalnf_tpu/data/native_loader.py``).

The library is compiled with the host's C++ compiler at first use into the
git-ignored ``_build/`` beside the package (named by a hash of the source
and flags), never at import.  Where it cannot be built, or ``CNF_NATIVE=0``
is set, the wrappers return None and the callers take their numpy paths,
as the reference's do: the library speeds up host data, it is not a device
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from categoricalnf_tpu_torch.ops.cuda.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus.cpp")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"corpus-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            path = (None if os.environ.get("CNF_NATIVE", "1") == "0"
                    else _build())
            if path is not None:
                lib = ctypes.CDLL(path)
                u64, i64, i32 = (ctypes.c_uint64, ctypes.c_int64,
                                 ctypes.c_int32)
                pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
                pf64 = np.ctypeslib.ndpointer(np.float64,
                                              flags="C_CONTIGUOUS")
                lib.gen_permutations.argtypes = [u64, i64, i32, pi32]
                lib.gen_sum_sequences.argtypes = [u64, i64, i32, i32, i32,
                                                  pi32]
                lib.gen_sum_sequences.restype = i64
                lib.gen_permutations.restype = None
                lib.markov_rollout.argtypes = [u64, pf64, i32, i64, i32, pi32]
                lib.chunk_corpus.argtypes = [u64, pi32, i64, i64, i32, pi32]
                lib.markov_rollout.restype = lib.chunk_corpus.restype = None
                _lib = lib
        return _lib


def gen_permutations(seed: int, n: int, S: int) -> Optional[np.ndarray]:
    """[n, S] int32 random permutations of 0..S-1; None without the
    library."""
    lib = library()
    if lib is None:
        return None
    out = np.empty((n, S), np.int32)
    lib.gen_permutations(seed & (2**64 - 1), n, S, out)
    return out


def gen_sum_sequences(seed: int, n: int, S: int, K: int,
                      target: int) -> Optional[np.ndarray]:
    """[n, S] int32 in 0..K-1 whose values shifted to 1..K sum to
    ``target``; None without the library or for sets above 512."""
    lib = library()
    if lib is None or S > 512:
        return None
    out = np.empty((n, S), np.int32)
    lib.gen_sum_sequences(seed & (2**64 - 1), n, S, K, target, out)
    return out


def markov_rollout(seed: int, P: np.ndarray, length: int,
                   start: int) -> Optional[np.ndarray]:
    """``length`` states of the Markov chain with transition matrix ``P``
    after the state ``start``; None without the library."""
    lib = library()
    if lib is None:
        return None
    cdf = np.cumsum(np.asarray(P, np.float64), axis=1).copy()
    out = np.empty(length, np.int32)
    lib.markov_rollout(seed & (2**64 - 1), cdf, P.shape[0], length, start,
                       out)
    return out


def chunk_corpus(seed: int, stream: np.ndarray, n: int,
                 T: int) -> Optional[np.ndarray]:
    """[n, T] random crops of ``stream``; None without the library."""
    lib = library()
    if lib is None:
        return None
    stream = np.ascontiguousarray(stream, np.int32)
    out = np.empty((n, T), np.int32)
    lib.chunk_corpus(seed & (2**64 - 1), stream, len(stream), n, T, out)
    return out
