"""Shared building blocks for coupling networks.

Counterpart of ``categoricalnf_tpu/networks/common.py``.  Weights are stored
fp32 as ``[in, out]``; a dense layer multiplies in the compute dtype with an
fp32 sum, adds the fp32 bias, and only then rounds to the compute dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from categoricalnf_tpu_torch.ops.numerics import at_least_f32

# float64 runs the plain path only (the fp32 train step's reference); the
# kernels and the user-facing options take fp32 and bf16
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {name!r}") from None


class Dense(nn.Module):
    """``w`` [in, out] and ``b`` [out], both fp32."""

    def __init__(self, in_dim: int, out_dim: int, *, scale: float = 1.0,
                 zero: bool = False, generator=None):
        super().__init__()
        if zero:
            w = torch.zeros(in_dim, out_dim)
        else:
            w = torch.randn(in_dim, out_dim, generator=generator) * (
                scale / math.sqrt(max(in_dim, 1)))
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, compute_dtype: torch.dtype):
        return dense(self.w, self.b, x, compute_dtype)


def dense(w, b, x, compute_dtype: torch.dtype) -> torch.Tensor:
    """x @ w + b with operands rounded to ``compute_dtype``, an fp32 sum and
    bias, then one rounding of the result.  The products of bf16 operands
    are exact in fp32, so the fp32 matmul (TF32 off) is bit-faithful to the
    reference's bf16 x bf16 -> fp32 contraction up to summation order."""
    y = at_least_f32(x.to(compute_dtype)) @ at_least_f32(w.to(compute_dtype))
    return (y + b).to(compute_dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LN without affine: fp32 statistics (biased variance), output in the
    input's dtype."""
    x32 = at_least_f32(x)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def concat_cond(x: torch.Tensor, cond) -> torch.Tensor:
    if cond is None:
        return x
    cond = cond.expand(*x.shape[:-1], cond.shape[-1])
    return torch.cat([x, cond.to(x.dtype)], dim=-1)
