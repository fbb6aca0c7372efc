"""Affine transform whose shift and scale come from the condition.

Counterpart of ``categoricalnf_tpu/flows/cond_affine.py``: fc1, a tanh
gelu and a zero-initialised fc2, both in fp32, map the condition (the
category embedding of an encoding's flow) to a bias and a log-scale capped
at ``scale_cap`` by a tanh; z -> (z + bias) exp(log-scale).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from categoricalnf_tpu_torch.flows.base import Transform, sum_ldj
from categoricalnf_tpu_torch.networks.common import Dense


class ConditionalAffine(Transform):
    def __init__(self, event_dim: int, cond_dim: int, *, hidden_dim: int = 32,
                 scale_cap: float = 3.0, generator=None):
        super().__init__()
        self.scale_cap = scale_cap
        self.fc1 = Dense(cond_dim, hidden_dim, generator=generator)
        self.fc2 = Dense(hidden_dim, 2 * event_dim, zero=True,
                         generator=generator)

    def _affine(self, cond, d: int):
        h = F.gelu(self.fc1(cond, torch.float32), approximate="tanh")
        raw = self.fc2(h, torch.float32)
        return raw[..., :d], self.scale_cap * torch.tanh(raw[..., d:]
                                                         / self.scale_cap)

    def forward(self, z, ldj, *, cond=None, mask=None):
        bias, log_scale = self._affine(cond, z.shape[-1])
        z = (z + bias) * torch.exp(log_scale)
        return z, ldj + sum_ldj(log_scale, mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        bias, log_scale = self._affine(cond, z.shape[-1])
        z = z * torch.exp(-log_scale) - bias
        return z, ldj - sum_ldj(log_scale, mask)
