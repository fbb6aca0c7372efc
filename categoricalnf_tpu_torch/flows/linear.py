"""Channel permutations and LU-parameterised invertible channel mixing
(GLOW 1x1).

Counterparts of ``ReverseChannels`` and ``InvertibleLinear`` in
``categoricalnf_tpu/flows/linear.py``.  ``InvertibleLinear``:
W = P @ L @ (U + diag(sign_s * exp(ls))), ls tanh-capped.  ``perm`` and
``sign_s`` are buffers, never trained.  Everything runs in fp32 with TF32
off (the reference uses ``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch
from torch import nn

from categoricalnf_tpu_torch.flows.base import Transform, sum_ldj
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


def _random_orthogonal(d: int, generator) -> torch.Tensor:
    a = torch.randn(d, d, generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


class ReverseChannels(Transform):
    """The channels in reverse order; its log-det is 0."""

    def forward(self, z, ldj, *, cond=None, mask=None):
        return z.flip(-1), ldj

    def inverse(self, z, ldj, *, cond=None, mask=None):
        return z.flip(-1), ldj


class InvertibleLinear(Transform):
    def __init__(self, event_dim: int, scale_cap: float = 5.0, *,
                 generator=None):
        super().__init__()
        self.scale_cap = scale_cap
        p, low, up = torch.linalg.lu(_random_orthogonal(event_dim, generator))
        s = torch.diagonal(up)
        self.register_buffer("perm", p.float())
        self.register_buffer("sign_s", torch.sign(s).float())
        self.lower = nn.Parameter(low.float())
        self.upper = nn.Parameter(torch.triu(up, diagonal=1).float())
        self.log_s = nn.Parameter(torch.log(s.abs() + 1e-12).float())

    def _ls(self):
        return self.scale_cap * torch.tanh(self.log_s / self.scale_cap)

    def _weight(self):
        d = self.log_s.shape[0]
        eye = torch.eye(d, dtype=self.log_s.dtype, device=self.log_s.device)
        low = torch.tril(self.lower, diagonal=-1) + eye
        up = torch.triu(self.upper, diagonal=1) + torch.diag(
            self.sign_s * torch.exp(self._ls()))
        return self.perm @ low @ up

    def forward(self, z, ldj, *, cond=None, mask=None):
        out = at_least_f32(z) @ self._weight()
        return out, ldj + sum_ldj(self._ls().expand(out.shape), mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        out = at_least_f32(z) @ torch.linalg.inv(self._weight())
        return out, ldj - sum_ldj(self._ls().expand(out.shape), mask)
