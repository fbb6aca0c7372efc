"""Sigmoid / logit bijections between the real line and (0, 1).

Counterpart of ``categoricalnf_tpu/flows/sigmoid.py``: the ldj of the
sigmoid is log sigmoid(x) + log sigmoid(-x); the logit direction clips its
input to [eps, 1 - eps] so that fp32 makes no infinities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from categoricalnf_tpu_torch.flows.base import Transform, sum_ldj
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


def _sigmoid_ldj(x):
    return F.logsigmoid(x) + F.logsigmoid(-x)


def _logit(z, eps: float):
    z = at_least_f32(z).clamp(eps, 1.0 - eps)
    return torch.log(z) - torch.log1p(-z)


class Sigmoid(Transform):
    """forward: R -> (0, 1) by the sigmoid; inverse: the logit."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, z, ldj, *, cond=None, mask=None):
        z = at_least_f32(z)
        return torch.sigmoid(z), ldj + sum_ldj(_sigmoid_ldj(z), mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        x = _logit(z, self.eps)
        return x, ldj - sum_ldj(_sigmoid_ldj(x), mask)


class Logit(Transform):
    """forward: (0, 1) -> R by the logit (Sigmoid's reverse)."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, z, ldj, *, cond=None, mask=None):
        x = _logit(z, self.eps)
        return x, ldj - sum_ldj(_sigmoid_ldj(x), mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        z = at_least_f32(z)
        return torch.sigmoid(z), ldj + sum_ldj(_sigmoid_ldj(z), mask)
