"""The 3xTF32 fp32 backward of the fused SetTransformer (kernel #4 in fp32,
``tools/f32_bwd_tf32x3.cu``), built and launched beside the port.

The port's fp32 train step runs the FMA pair of
``categoricalnf_tpu_torch/csrc/fused_transformer.cu``.  This backward, tied
to the port's 3xTF32 forward, fails the fp32 train step's gradient check on
a tensor where nets computed exactly in fp64 fail it too, so it waits on
that check (PERF.md; ROADMAP.md, Queue C).  ``tools/f32_forward_rounding.py``
holds the check against it and ``tools/fused_ab.py`` times it.  Load it by
path (``importlib``), so that each checkout's copy is the one that runs:

    fused_set_transformer_bwd(packed, x, g, num_heads=4)

``packed``: the port's fp32 ``PackedWeights``.  Returns what the port's
``fused_set_transformer_bwd`` returns.  The source is compiled with the
port's nvcc flags into the port's git-ignored build directory on first use,
named by a hash of the source, the port's headers and the flags.  Nothing is
built at import.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import math
import os
import subprocess
import threading
import weakref

import torch

from categoricalnf_tpu_torch.ops.cuda import build
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "f32_bwd_tf32x3.cu")
ENTRY = "fused_set_transformer_bwd_f32_tf32x3"
TILE_TARGET = 16  # must agree with kBwdTileTarget in the source

_lock = threading.Lock()
_fn = None
_weights: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def bwd_shape(set_size: int, in_dim: int, hidden: int, mlp: int,
              out_dim: int, heads: int, layers: int) -> tuple[int, int]:
    """(rows of a tile, dynamic shared memory of one block), as
    ``pick_bwd_layout`` picks them: whole sets up to 16 rows (one set where
    a set is larger), no padded rows, the rows 4 mod 8 floats wide
    (``conflict_free``) or, where that does not fit, at their true width.
    It holds the residual stream at each of the layers + 1 block
    boundaries, five [tile, H] buffers, qkv, a region for the MLP pair / the
    qkv gradient / g / x, the softmax statistics and F32_SLACK floats."""
    tile = ft._tile(set_size, TILE_TARGET, 1)[0]
    for ld in (ft.conflict_free, int):
        ld_h, ld_qkv = ld(hidden), ld(3 * hidden)
        ld_r2 = max(2 * ld(mlp), ld_qkv, ld(out_dim), ld(in_dim))
        smem = 4 * (tile * ((layers + 6) * ld_h + ld_qkv + ld_r2 + 3 * heads)
                    + ft.F32_SLACK)
        if smem <= ft.MAX_SMEM:
            break
    return tile, smem


def w_layouts(mats) -> list:
    """The layouts of the weights ``mats`` (each W [..., kd, n], fp32) that
    the input gradients g @ W^T read as their B operands: W split as
    ``tf32x3_layouts`` splits W^T, [..., pad8(kd), 2 pad8(n)]."""
    return ft.tf32x3_layouts([m.transpose(-1, -2) for m in mats])


def bwd_weights(packed: ft.PackedWeights):
    """The 12 matrices the kernel reads, the forward's split W^T layouts
    then ``w_layouts``, and their pointer array; built once a repack."""
    got = _weights.get(packed)
    if got is None:
        with torch.no_grad():
            mats = list(packed.mats) + w_layouts(packed.bwd_mats)
        got = _weights[packed] = (mats, ft._ptrs(mats))
    return got


def _library() -> str:
    digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for path in [SOURCE, *sorted(glob.glob(os.path.join(build.CSRC,
                                                        "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(build.BUILD_DIR,
                      f"f32_bwd_tf32x3-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        with open(f"{so}.log", "w") as log:
            done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                                   build.CSRC, "-o", tmp, SOURCE],
                                  stdout=log, stderr=subprocess.STDOUT)
        if done.returncode != 0:
            with open(f"{so}.log") as f:
                raise RuntimeError(f"nvcc failed for {SOURCE}:\n{f.read()}")
        os.replace(tmp, so)
    return so


def build_log() -> str:
    """nvcc's log of the build (ptxas: registers, spills), building first
    where needed."""
    with _lock:
        so = _library()
    with open(f"{so}.log") as f:
        return f.read()


def _entry():
    global _fn
    with _lock:
        if _fn is None:
            fn = getattr(ctypes.CDLL(_library()), ENTRY)
            fn.argtypes, fn.restype = ft._BWD_ARGS, ctypes.c_int
            _fn = fn
    return _fn


def fused_set_transformer_bwd(packed: ft.PackedWeights, x, g, *,
                              num_heads: int):
    """The cotangent ``g`` [B, S, OUT] of the fp32 net's output pulled back
    to x and the 12 weights, by the 3xTF32 kernel, which recomputes with the
    3xTF32 forward's arithmetic.  Returns (dx, 12 fp32 weight gradients
    shaped as ``flatten_params``)."""
    if packed.dtype != torch.float32:
        raise TypeError("the 3xTF32 backward takes fp32 weights")
    ft._check_x(packed, x, num_heads, "3xTF32 backward")
    B, S, in_dim = x.shape
    H, L, RH, OUT = packed.hidden, packed.layers, packed.mlp, packed.out_dim
    if tuple(g.shape) != (B, S, OUT) or g.device != x.device:
        raise ValueError(f"3xTF32 backward: g {tuple(g.shape)} on "
                         f"{g.device}, want {(B, S, OUT)} on {x.device}")
    tile, smem = bwd_shape(S, in_dim, H, RH, OUT, num_heads, L)
    if smem > ft.MAX_SMEM:
        raise ValueError(f"3xTF32 backward: a tile needs {smem} bytes of "
                         f"shared memory, over {ft.MAX_SMEM}")
    x2 = x.detach().float().contiguous()
    g2 = g.detach().float().contiguous()
    sizes = [math.prod(shape) for shape in packed.shapes]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = ft.bwd_grid(B * S, tile, smem, sms)
    dx = torch.empty_like(x2)
    part = torch.empty(grid, sum(sizes), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    _, w_ptrs = bwd_weights(packed)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(x2.data_ptr(), g2.data_ptr(), w_ptrs, packed.b_ptrs,
                       dx.data_ptr(), part.data_ptr(), dw.data_ptr(), B * S,
                       S, in_dim, H, num_heads, L, RH, OUT, grid, stream)
    build.check(err, ENTRY)
    dws = tuple(t.view(shape) for t, shape in
                zip(dw.split(sizes), packed.shapes))
    return dx, dws
