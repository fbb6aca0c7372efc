"""Transform protocol (counterpart of ``categoricalnf_tpu/flows/base.py``).

A Transform is an ``nn.Module`` that owns its parameters.  ``z`` is
``[B, T, D]``, ``ldj`` the running log-det ``[B]`` in fp32, ``mask`` an
optional ``[B, T]`` validity mask.  ``forward`` maps data toward the prior,
``inverse`` is the sampling direction.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from categoricalnf_tpu_torch.ops.numerics import at_least_f32


def sum_ldj(per_elem: torch.Tensor, mask: Optional[torch.Tensor]):
    """Reduce a per-element ldj tensor [B, T, D] (or [B, T]) to [B]."""
    per_elem = at_least_f32(per_elem)
    if mask is not None:
        m = at_least_f32(mask)
        while m.dim() < per_elem.dim():
            m = m[..., None]
        per_elem = per_elem * m
    return per_elem.reshape(per_elem.shape[0], -1).sum(dim=1)


def apply_mask(z: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return z
    m = mask.to(z.dtype)
    while m.dim() < z.dim():
        m = m[..., None]
    return z * m


class Transform(nn.Module):
    """Base class; subclasses implement ``forward`` and ``inverse``."""

    has_data_init = False

    def forward(self, z, ldj, *, cond=None, mask=None):
        raise NotImplementedError

    def inverse(self, z, ldj, *, cond=None, mask=None):
        raise NotImplementedError

    @torch.no_grad()
    def data_init(self, z, *, cond=None, mask=None):
        """Data-dependent init: update parameters in place (so that modules
        sharing them see the update) and return the forwarded z."""
        z, _ = self.forward(z, at_least_f32(z.new_zeros(z.shape[0])),
                            cond=cond, mask=mask)
        return z
