"""Wrappers of the CUDA mixture-CDF kernels (``csrc/mixture.cu``).

Counterparts of ``mixture_inverse_pallas`` and ``mixture_forward_pallas``.
Their plain versions are ``ops.numerics.mixture_inverse_logit_cdf`` and
``ops.numerics.mixture_logit_cdf_and_ldj``; ``ops.dispatch`` sends CPU
tensors there.  These wrappers take CUDA tensors only and raise on anything
the kernels do not take.  ``LAUNCHES`` counts the kernel launches.

Both are differentiable.  ``MixtureForward`` pulls gradients back through
the hand-written backward kernel (``mixture_forward_bwd_f32``), whose plain
version is autograd through the numerics.  ``MixtureInverse``'s backward,
#1', is the reference's rule: the reference differentiates its inverse's
loop (42 bisections, 3 clipped Newton steps) with XLA's reverse mode, and
the loop-rule kernel (``mixture_inverse_loop_bwd_f32``) reruns that loop
from the inputs and pulls the cotangent back through it
(``numerics.mixture_inverse_loop_vjp`` is its plain version; autograd
through ``numerics.mixture_inverse_logit_cdf`` its spec).  The implicit
rule at the root x* (``mixture_inverse_bwd_cuda``: #2 gives ldj(x*), g_y =
g_x exp(-ldj), #2' with the cotangents (-g_y, 0) the parameters'
gradients, the exact derivative) is on no path of the port: the checks
hold it beside the loop rule as their control.
"""

from __future__ import annotations

import ctypes

import torch

from categoricalnf_tpu_torch.ops.cuda import build

MAX_K = 32
# the inverse's cap on rtsafe iterations: kMaxIters in csrc/mixture.cu (an
# element stops earlier once it is done; ``mixture_inverse_iterations``
# reads how many it ran)
MAX_ITERS = 48

LAUNCHES = {"mixture_inverse": 0, "mixture_forward": 0,
            "mixture_forward_bwd": 0, "mixture_inverse_bwd": 0,
            "mixture_inverse_loop_bwd": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


def _lib():
    lib = build.load("mixture")
    if not getattr(lib, "_cnf_typed", False):
        lib.mixture_inverse_f32.argtypes = [_P, _P, _L, _P, _L, _P, _L, _P,
                                            _P, _L, _I, _P]
        lib.mixture_inverse_f32.restype = _I
        lib.mixture_forward_f32.argtypes = [_P, _P, _L, _P, _L, _P, _L, _P,
                                            _P, _L, _I, _P]
        lib.mixture_forward_f32.restype = _I
        lib.mixture_forward_bwd_f32.argtypes = [_P, _P, _L, _P, _L, _P, _L,
                                                _P, _P, _P, _P, _P, _P, _L,
                                                _I, _P]
        lib.mixture_forward_bwd_f32.restype = _I
        lib.mixture_inverse_loop_bwd_f32.argtypes = [_P, _P, _L, _P, _L, _P,
                                                     _L, _P, _P, _P, _P, _P,
                                                     _L, _I, _P]
        lib.mixture_inverse_loop_bwd_f32.restype = _I
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


def _inverse_launch(y, pi_logits, means, log_scales,
                    iters=None) -> torch.Tensor:
    """#1; with ``iters`` (int32, y's shape) it also writes there the
    rtsafe iterations each element ran."""
    k = _check(y, pi_logits, means, log_scales, "mixture_inverse")
    m = y.numel()
    y1 = y.contiguous()
    pi, mu, ls = _params(m, k, pi_logits, means, log_scales)
    out = torch.empty_like(y1)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mixture_inverse_f32(
            y1.data_ptr(), pi.data_ptr(), pi.stride(0), mu.data_ptr(),
            mu.stride(0), ls.data_ptr(), ls.stride(0), out.data_ptr(),
            None if iters is None else iters.data_ptr(), m, k, stream)
    build.check(err, "mixture_inverse_f32")
    LAUNCHES["mixture_inverse"] += 1
    return out


def mixture_inverse_iterations(y, pi_logits, means, log_scales):
    """(x, the rtsafe iterations each element of #1 ran, int32): what the
    work of a call depends on, for its operation count."""
    iters = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    return _inverse_launch(y, pi_logits, means, log_scales, iters), iters


def _params(m, k, pi_logits, means, log_scales):
    return tuple(_rows(t, m, k, n) for t, n in ((pi_logits, "pi_logits"),
                                                 (means, "means"),
                                                 (log_scales, "log_scales")))


def _forward_launch(x, pi_logits, means, log_scales):
    k = _check(x, pi_logits, means, log_scales, "mixture_forward")
    m = x.numel()
    x1 = x.contiguous()
    pi, mu, ls = _params(m, k, pi_logits, means, log_scales)
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


def mixture_forward_bwd_cuda(x, pi_logits, means, log_scales, gy, gldj):
    """(gx, gpi, gmu, gls): the cotangents ``gy``, ``gldj`` of
    ``mixture_forward_cuda``'s (y, ldj) pulled back to its four inputs by
    the backward kernel, which recomputes the per-component terms.  The gls
    of a clipped log-scale is 0 (``torch.clamp``'s gradient)."""
    k = _check(x, pi_logits, means, log_scales, "mixture_forward_bwd")
    for name, t in (("gy", gy), ("gldj", gldj)):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"mixture_forward_bwd: {name} must be float32 on "
                            f"{x.device}")
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"mixture_forward_bwd: {name} shape "
                             f"{tuple(t.shape)}, want {tuple(x.shape)}")
    m = x.numel()
    x1, gy1, gl1 = x.contiguous(), gy.contiguous(), gldj.contiguous()
    pi, mu, ls = _params(m, k, pi_logits, means, log_scales)
    gx = torch.empty_like(x1)
    gpi, gmu, gls = (torch.empty(m, k, dtype=torch.float32, device=x.device)
                     for _ in range(3))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mixture_forward_bwd_f32(
            x1.data_ptr(), pi.data_ptr(), pi.stride(0), mu.data_ptr(),
            mu.stride(0), ls.data_ptr(), ls.stride(0), gy1.data_ptr(),
            gl1.data_ptr(), gx.data_ptr(), gpi.data_ptr(), gmu.data_ptr(),
            gls.data_ptr(), m, k, stream)
    build.check(err, "mixture_forward_bwd_f32")
    LAUNCHES["mixture_forward_bwd"] += 1
    shape = tuple(pi_logits.shape)
    return (gx.view(x.shape), gpi.view(shape), gmu.view(shape),
            gls.view(shape))


def mixture_inverse_bwd_cuda(x, pi_logits, means, log_scales, gx):
    """The implicit rule: (gy, gpi, gmu, gls), the cotangent ``gx`` of the
    inverse's root ``x`` pulled back to its four inputs, from one launch of
    #2 (ldj at x) and one of #2' (the cotangents (-gy, 0)).  The gls of a
    clipped log-scale is 0, as in #2'.  The exact derivative, which the
    reference does not take: the control of the checks of #1'."""
    _, ldj = _forward_launch(x, pi_logits, means, log_scales)
    gy = gx * torch.exp(-ldj)
    _, gpi, gmu, gls = mixture_forward_bwd_cuda(
        x, pi_logits, means, log_scales, -gy, torch.zeros_like(gy))
    LAUNCHES["mixture_inverse_bwd"] += 1
    return gy, gpi, gmu, gls


def mixture_inverse_loop_bwd_cuda(y, pi_logits, means, log_scales, gx):
    """#1': (gy, gpi, gmu, gls), the cotangent ``gx`` of the inverse's root
    pulled back to its four inputs through the reference's loop, which the
    kernel reruns from them (``numerics.mixture_inverse_loop_vjp`` is its
    plain version).  The gls of a clipped log-scale is 0."""
    k = _check(y, pi_logits, means, log_scales, "mixture_inverse_loop_bwd")
    if (gx.device != y.device or gx.dtype != torch.float32
            or tuple(gx.shape) != tuple(y.shape)):
        raise ValueError(f"mixture_inverse_loop_bwd: gx must be float32 "
                         f"{tuple(y.shape)} on {y.device}")
    m = y.numel()
    y1, gx1 = y.contiguous(), gx.contiguous()
    pi, mu, ls = _params(m, k, pi_logits, means, log_scales)
    gy = torch.empty_like(y1)
    gpi, gmu, gls = (torch.empty(m, k, dtype=torch.float32, device=y.device)
                     for _ in range(3))
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mixture_inverse_loop_bwd_f32(
            y1.data_ptr(), pi.data_ptr(), pi.stride(0), mu.data_ptr(),
            mu.stride(0), ls.data_ptr(), ls.stride(0), gx1.data_ptr(),
            gy.data_ptr(), gpi.data_ptr(), gmu.data_ptr(), gls.data_ptr(), m,
            k, stream)
    build.check(err, "mixture_inverse_loop_bwd_f32")
    LAUNCHES["mixture_inverse_loop_bwd"] += 1
    shape = tuple(pi_logits.shape)
    return (gy.view(y.shape), gpi.view(shape), gmu.view(shape),
            gls.view(shape))


class MixtureInverse(torch.autograd.Function):
    """The root x of #1; its backward is #1'
    (``mixture_inverse_loop_bwd_cuda``), which reruns the reference's loop
    from the inputs: only they are saved."""

    @staticmethod
    def forward(ctx, y, pi_logits, means, log_scales):
        ctx.save_for_backward(y, pi_logits, means, log_scales)
        return _inverse_launch(y, pi_logits, means, log_scales)

    @staticmethod
    def backward(ctx, gx):
        return mixture_inverse_loop_bwd_cuda(*ctx.saved_tensors,
                                             gx.contiguous())


def mixture_inverse_cuda(y, pi_logits, means, log_scales) -> torch.Tensor:
    """x with logit F(x) = y, by rtsafe in the kernel; shapes as numerics.
    Differentiable in all four inputs (``MixtureInverse``)."""
    return MixtureInverse.apply(y, pi_logits, means, log_scales)


class MixtureForward(torch.autograd.Function):
    """(y, ldj) of the forward kernel; its backward is the backward kernel.
    Nothing but the inputs is saved: the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, pi_logits, means, log_scales):
        ctx.save_for_backward(x, pi_logits, means, log_scales)
        return _forward_launch(x, pi_logits, means, log_scales)

    @staticmethod
    def backward(ctx, gy, gldj):
        return mixture_forward_bwd_cuda(*ctx.saved_tensors, gy, gldj)


def mixture_forward_cuda(x, pi_logits, means, log_scales):
    """(y, ldj) of x -> logit F(x) in the kernel; shapes as numerics.
    Differentiable in all four inputs (``MixtureForward``)."""
    return MixtureForward.apply(x, pi_logits, means, log_scales)
