"""Mixture-CDF coupling layer (counterpart of
``categoricalnf_tpu/flows/coupling.py``; a channel or a checker mask).

    y = logit(MixLogisticCDF(x)) * exp(a) + t

on the transformed channels, with per-element ldj
``log f - log F - log(1 - F) + a``.  The coupling net emits ``2 + 3K`` raw
numbers per element, laid out ``[t, a, pi x K, mu x K, log-scale x K]``.
The channel mask splits the channels, the checker mask alternates the
positions.
Both directions go through ``ops.dispatch`` (kernels on CUDA tensors).
"""

from __future__ import annotations

import torch
from torch import nn

from categoricalnf_tpu_torch.flows.base import Transform, sum_ldj
from categoricalnf_tpu_torch.ops import dispatch
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


def make_channel_mask(event_dim: int, parity: int, device=None):
    """[D] mask: 1 = conditioning (kept), 0 = transformed."""
    m = (torch.arange(event_dim, device=device) < (event_dim + 1) // 2).float()
    return m if parity == 0 else 1.0 - m


def make_checker_mask(num_pos: int, parity: int, device=None):
    """[T] alternating position mask: 1 = conditioning, 0 = transformed."""
    m = (torch.arange(num_pos, device=device) % 2 == 0).float()
    return m if parity == 0 else 1.0 - m


class MixtureCDFCoupling(Transform):
    def __init__(self, net: nn.Module, event_dim: int, *, parity: int = 0,
                 num_mixtures: int = 8, scale_cap: float = 3.0,
                 mask_kind: str = "channel", generator=None):
        super().__init__()
        if mask_kind not in ("channel", "checker"):
            raise ValueError(f"unknown mask kind {mask_kind!r}")
        self.net = net
        self.mask_kind = mask_kind
        self.parity = parity
        self.num_mixtures = num_mixtures
        self.scale_cap = scale_cap
        # per-(channel, K) mean offsets break component symmetry at init
        self.mean_offsets = nn.Parameter(
            torch.randn(event_dim, num_mixtures, generator=generator) * 0.5)

    def _mask(self, z):
        if self.mask_kind == "channel":
            return make_channel_mask(z.shape[-1], self.parity, z.device)
        return make_checker_mask(z.shape[-2], self.parity,
                                 z.device)[:, None]

    def _params_for(self, z, cond, mask):
        m = self._mask(z)
        raw = self.net(z * m, cond=cond, mask=mask)
        K = self.num_mixtures
        raw = at_least_f32(raw.reshape(*z.shape, 2 + 3 * K))
        t = raw[..., 0]
        a = self.scale_cap * torch.tanh(raw[..., 1] / self.scale_cap)
        pi_logits = raw[..., 2:2 + K]
        means = raw[..., 2 + K:2 + 2 * K] + self.mean_offsets
        log_scales = raw[..., 2 + 2 * K:]
        return m, t, a, pi_logits, means, log_scales

    def forward(self, z, ldj, *, cond=None, mask=None):
        m, t, a, pi, mu, ls = self._params_for(z, cond, mask)
        z32 = at_least_f32(z)
        y, elem_ldj = dispatch.mixture_forward(z32, pi, mu, ls)
        y = y * torch.exp(a) + t
        out = m * z32 + (1.0 - m) * y
        return out, ldj + sum_ldj((elem_ldj + a) * (1.0 - m), mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        # the net's input z * m is untouched by the transform: one pass
        m, t, a, pi, mu, ls = self._params_for(z, cond, mask)
        z32 = at_least_f32(z)
        u = (z32 - t) * torch.exp(-a)
        x = dispatch.mixture_inverse(u, pi, mu, ls)
        out = m * z32 + (1.0 - m) * x
        _, elem_ldj = dispatch.mixture_forward(x, pi, mu, ls)
        return out, ldj - sum_ldj((elem_ldj + a) * (1.0 - m), mask)
