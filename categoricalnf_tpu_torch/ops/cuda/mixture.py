"""Wrappers of the CUDA mixture-CDF kernels (``csrc/mixture.cu``).

Counterparts of ``mixture_inverse_pallas`` and ``mixture_forward_pallas``.
Their plain versions are ``ops.numerics.mixture_inverse_logit_cdf`` and
``ops.numerics.mixture_logit_cdf_and_ldj``; ``ops.dispatch`` sends CPU
tensors there.  These wrappers take CUDA tensors only and raise on anything
the kernels do not take.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from categoricalnf_tpu_torch.ops.cuda import build

MAX_K = 16
# rtsafe iterations of the inverse: kNumIters in csrc/mixture.cu, here for
# operation counts only
NUM_ITERS = 24

LAUNCHES = {"mixture_inverse": 0, "mixture_forward": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


def _lib():
    lib = build.load("mixture")
    if not getattr(lib, "_cnf_typed", False):
        lib.mixture_inverse_f32.argtypes = [_P, _P, _L, _P, _L, _P, _L, _P,
                                            _L, _I, _P]
        lib.mixture_inverse_f32.restype = _I
        lib.mixture_forward_f32.argtypes = [_P, _P, _L, _P, _L, _P, _L, _P,
                                            _P, _L, _I, _P]
        lib.mixture_forward_f32.restype = _I
        lib._cnf_typed = True
    return lib


def _rows(t: torch.Tensor, m: int, k: int, name: str) -> torch.Tensor:
    """``t`` [..., K] fp32 on the card as an [M, K] view with unit column
    stride; the row stride is passed to the kernel, so slices of the
    coupling net's output need no copy."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    t2 = t.reshape(m, k)
    if t2.stride(1) != 1 or (m > 1 and t2.stride(0) < k):
        t2 = t2.contiguous()
    return t2


def _check(x: torch.Tensor, pi, mu, ls, what: str) -> int:
    for name, t in (("x", x), ("pi_logits", pi), ("means", mu),
                    ("log_scales", ls)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is not a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"x on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x must be float32, got {x.dtype}")
    k = pi.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: K={k} outside 1..{MAX_K}")
    want = tuple(x.shape) + (k,)
    for name, t in (("pi_logits", pi), ("means", mu), ("log_scales", ls)):
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)}, "
                             f"want {want}")
    return k


def mixture_inverse_cuda(y, pi_logits, means, log_scales) -> torch.Tensor:
    """x with logit F(x) = y, by rtsafe in the kernel; shapes as numerics."""
    k = _check(y, pi_logits, means, log_scales, "mixture_inverse")
    m = y.numel()
    y1 = y.contiguous()
    pi, mu, ls = (_rows(t, m, k, n) for t, n in ((pi_logits, "pi_logits"),
                                                  (means, "means"),
                                                  (log_scales, "log_scales")))
    out = torch.empty_like(y1)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mixture_inverse_f32(
            y1.data_ptr(), pi.data_ptr(), pi.stride(0), mu.data_ptr(),
            mu.stride(0), ls.data_ptr(), ls.stride(0), out.data_ptr(), m, k,
            stream)
    build.check(err, "mixture_inverse_f32")
    LAUNCHES["mixture_inverse"] += 1
    return out


def mixture_forward_cuda(x, pi_logits, means, log_scales):
    """(y, ldj) of x -> logit F(x) in the kernel; shapes as numerics."""
    k = _check(x, pi_logits, means, log_scales, "mixture_forward")
    m = x.numel()
    x1 = x.contiguous()
    pi, mu, ls = (_rows(t, m, k, n) for t, n in ((pi_logits, "pi_logits"),
                                                  (means, "means"),
                                                  (log_scales, "log_scales")))
    y = torch.empty_like(x1)
    ldj = torch.empty_like(x1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mixture_forward_f32(
            x1.data_ptr(), pi.data_ptr(), pi.stride(0), mu.data_ptr(),
            mu.stride(0), ls.data_ptr(), ls.stride(0), y.data_ptr(),
            ldj.data_ptr(), m, k, stream)
    build.check(err, "mixture_forward_f32")
    LAUNCHES["mixture_forward"] += 1
    return y, ldj
