"""Flow composition: an ordered stack of Transforms plus a prior.

Counterpart of ``categoricalnf_tpu/flows/model.py``.  A parametric prior
(``HMMPrior``) is an ``nn.Module`` and so a submodule, ``flow.prior``, whose
parameters the optimizer trains with the layers' (the reference carries
them as the last entry of the flow's parameter tuple).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from categoricalnf_tpu_torch.flows.base import Transform
from categoricalnf_tpu_torch.flows.distributions import LogisticPrior
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


class FlowModel(nn.Module):
    def __init__(self, layers: Sequence[Transform], prior=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.prior = LogisticPrior() if prior is None else prior

    def _zero_ldj(self, z):
        return at_least_f32(z.new_zeros(z.shape[0]))

    def forward(self, z, ldj=None, *, cond=None, mask=None):
        """Data -> prior direction; returns (z_K, ldj)."""
        ldj = self._zero_ldj(z) if ldj is None else ldj
        for layer in self.layers:
            z, ldj = layer(z, ldj, cond=cond, mask=mask)
        return z, ldj

    def inverse(self, z, ldj=None, *, cond=None, mask=None):
        """Prior -> data direction (sampling)."""
        ldj = self._zero_ldj(z) if ldj is None else ldj
        for layer in reversed(self.layers):
            z, ldj = layer.inverse(z, ldj, cond=cond, mask=mask)
        return z, ldj

    def log_prob(self, z0, *, cond=None, mask=None):
        zk, ldj = self.forward(z0, cond=cond, mask=mask)
        return self.prior.log_prob(zk, mask) + ldj

    def sample(self, shape, *, cond=None, mask=None, temperature=1.0,
               generator=None, noise=None, device=None):
        zk = self.prior.sample(shape, temperature, generator=generator,
                               noise=noise, device=device)
        z0, _ = self.inverse(zk, cond=cond, mask=mask)
        return z0

    @torch.no_grad()
    def data_init(self, z, *, cond=None, mask=None):
        """Calibration pass: layers with ``has_data_init`` (ActNorm) take
        the statistics of the activations they see, in place."""
        for layer in self.layers:
            if layer.has_data_init:
                z = layer.data_init(z, cond=cond, mask=mask)
            else:
                z, _ = layer(z, self._zero_ldj(z), cond=cond, mask=mask)
        return z
