"""Activation normalization with masked data-dependent init.

Counterparts of ``ActNorm`` and ``ExtActNorm`` in
``categoricalnf_tpu/flows/actnorm.py``: ``y = (z + bias) * exp(ls)`` with
``ls = cap * tanh(log_scale / cap)``; ``ExtActNorm`` takes its bias and
raw log-scale from ``cond``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from categoricalnf_tpu_torch.flows.base import Transform, sum_ldj
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


class ActNorm(Transform):
    has_data_init = True

    def __init__(self, event_dim: int, scale_cap: float = 5.0):
        super().__init__()
        self.scale_cap = scale_cap
        self.bias = nn.Parameter(torch.zeros(event_dim))
        self.log_scale = nn.Parameter(torch.zeros(event_dim))

    def _ls(self):
        return self.scale_cap * torch.tanh(self.log_scale / self.scale_cap)

    def forward(self, z, ldj, *, cond=None, mask=None):
        ls = self._ls()
        z = (z + self.bias) * torch.exp(ls)
        return z, ldj + sum_ldj(ls.expand(z.shape), mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        ls = self._ls()
        z = z * torch.exp(-ls) - self.bias
        return z, ldj - sum_ldj(ls.expand(z.shape), mask)

    @torch.no_grad()
    def data_init(self, z, *, cond=None, mask=None):
        mean, var = _masked_moments(z, mask)
        cap = self.scale_cap
        target = (-0.5 * torch.log(var + 1e-6)).clamp(-cap + 0.1, cap - 0.1)
        self.bias.copy_(-mean)
        # invert the tanh cap so the effective scale hits the target
        self.log_scale.copy_(cap * torch.atanh(target / cap))
        z, _ = self.forward(z, at_least_f32(z.new_zeros(z.shape[0])),
                            mask=mask)
        return z


def _masked_moments(z: torch.Tensor, mask: Optional[torch.Tensor]):
    """Per-channel mean and biased variance over batch and positions."""
    flat = at_least_f32(z).reshape(-1, z.shape[-1])
    if mask is None:
        mean = flat.mean(dim=0)
        var = ((flat - mean) ** 2).mean(dim=0)
    else:
        m = at_least_f32(mask).reshape(-1, 1)
        denom = m.sum().clamp_min(1.0)
        mean = (flat * m).sum(dim=0) / denom
        var = ((flat - mean) ** 2 * m).sum(dim=0) / denom
    return mean, var


class ExtActNorm(Transform):
    """The affine of ``ActNorm`` with its bias and raw log-scale given by
    ``cond`` ([..., 2D]: the first D channels the bias, the next D the raw
    log-scale, squashed as ``cap * tanh(raw / cap)``); no parameters."""

    def __init__(self, scale_cap: float = 3.0):
        super().__init__()
        self.scale_cap = scale_cap

    def _split(self, cond, d: int):
        bias, raw = cond[..., :d], cond[..., d:2 * d]
        return bias, self.scale_cap * torch.tanh(raw / self.scale_cap)

    def forward(self, z, ldj, *, cond=None, mask=None):
        bias, ls = self._split(cond, z.shape[-1])
        return (z + bias) * torch.exp(ls), ldj + sum_ldj(ls, mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        bias, ls = self._split(cond, z.shape[-1])
        return z * torch.exp(-ls) - bias, ldj - sum_ldj(ls, mask)
