"""SoftClamp: exact smooth bijection bounding activations to (-c, c).

Counterpart of ``categoricalnf_tpu/flows/softclamp.py``:
y = c tanh(x / c), ldj = sum 2 log sech(x / c).  Keeps every block's output
inside fp32 resolution so the claimed ldj stays the ldj of the computed map.
"""

from __future__ import annotations

import torch

from categoricalnf_tpu_torch.flows.base import Transform, sum_ldj
from categoricalnf_tpu_torch.ops.numerics import at_least_f32

_LOG2 = 0.6931471805599453


def _log_cosh(u):
    au = u.abs()
    return au + torch.log1p(torch.exp(-2.0 * au)) - _LOG2


class SoftClamp(Transform):
    def __init__(self, cap: float = 30.0):
        super().__init__()
        self.cap = cap

    def forward(self, z, ldj, *, cond=None, mask=None):
        u = at_least_f32(z) / self.cap
        return self.cap * torch.tanh(u), ldj + sum_ldj(-2.0 * _log_cosh(u),
                                                       mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        v = (at_least_f32(z) / self.cap).clamp(-1.0 + 1e-6, 1.0 - 1e-6)
        x = self.cap * torch.atanh(v)
        return x, ldj - sum_ldj(-2.0 * _log_cosh(x / self.cap), mask)
