"""Time-autoregressive mixture-CDF transform of the language-modeling flows.

Counterpart of ``categoricalnf_tpu/flows/autoregressive.py``.  Every channel
at step t transforms conditioned on the steps before t, through a causal
net (``networks.CausalLSTM``):

    y_t = logit(MixLogisticCDF(z_t)) * exp(a) + t

with the net's ``2 + 3K`` raw numbers an element laid out as the
coupling's.  The density pass is one causal pass of the net over the whole
sequence; the inverse (sampling) is sequential in t, rolling the net's
state one step at a time.  Both directions go through ``ops.dispatch``: on
the card the forward runs #2 (and #2' under grad), each inverse step #1 and
then #2 for its ldj.
"""

from __future__ import annotations

import torch
from torch import nn

from categoricalnf_tpu_torch.flows.base import Transform, sum_ldj
from categoricalnf_tpu_torch.flows.coupling import make_channel_mask
from categoricalnf_tpu_torch.ops import dispatch
from categoricalnf_tpu_torch.ops import numerics as nm


class _InputFeatures(nn.Module):
    """The reference's ``feat``: a V-component Gaussian-mixture posterior
    softmax of the net's input, concatenated to it."""

    def __init__(self, num: int, event_dim: int, generator):
        super().__init__()
        self.mu = nn.Parameter(torch.randn(num, event_dim,
                                           generator=generator))
        self.log_sigma = nn.Parameter(torch.zeros(num, event_dim))
        self.bias = nn.Parameter(torch.zeros(num))

    def forward(self, z):
        # clamped like every learned log-scale: an unbounded exp(-log_sigma)
        # could overflow the squared distance and NaN the softmax
        inv = torch.exp(-self.log_sigma.clamp(nm.LOG_SCALE_MIN,
                                              nm.LOG_SCALE_MAX))
        diff = (z[..., None, :] - self.mu) * inv            # [..., V, D]
        logits = -0.5 * (diff * diff).sum(-1) + self.bias   # [..., V]
        return torch.cat([z, torch.softmax(logits, dim=-1)], dim=-1)


class AutoregressiveMixtureCDF(Transform):
    """With ``parity=None`` the channels at step t are conditionally
    independent given the steps before t.  With an integer parity the layer
    is also a coupling in channels: the masked-in half of z_t stays as it is
    and joins the net's output head as ``extra`` for the transformed half
    (the sequential inverse still works, since the masked-in channels of z_t
    equal those of y_t).  ``input_feats`` > 0 concatenates the soft
    classifier features of the net's input (``_InputFeatures``)."""

    def __init__(self, net: nn.Module, event_dim: int, *,
                 num_mixtures: int = 8, scale_cap: float = 3.0,
                 parity=None, input_feats: int = 0, generator=None):
        super().__init__()
        self.net = net
        self.num_mixtures = num_mixtures
        self.scale_cap = scale_cap
        self.parity = parity
        self.input_feats = input_feats
        self.mean_offsets = nn.Parameter(
            torch.randn(event_dim, num_mixtures, generator=generator) * 0.5)
        self.feat = (_InputFeatures(input_feats, event_dim, generator)
                     if input_feats else None)

    def _chan_mask(self, z):
        """[D]: 1 = kept (conditioning), 0 = transformed."""
        if self.parity is None:
            return z.new_zeros(z.shape[-1])
        return make_channel_mask(z.shape[-1], self.parity,
                                 z.device).to(z.dtype)

    def _net_input(self, z):
        return z if self.feat is None else self.feat(z)

    def _split_raw(self, raw, shape):
        K = self.num_mixtures
        raw = nm.at_least_f32(raw.reshape(*shape, 2 + 3 * K))
        t = raw[..., 0]
        a = self.scale_cap * torch.tanh(raw[..., 1] / self.scale_cap)
        pi_logits = raw[..., 2:2 + K]
        means = raw[..., 2 + K:2 + 2 * K] + self.mean_offsets
        log_scales = raw[..., 2 + 2 * K:]
        return t, a, pi_logits, means, log_scales

    def forward(self, z, ldj, *, cond=None, mask=None):
        z32 = nm.at_least_f32(z)
        m = self._chan_mask(z32)
        extra = z32 * m if self.parity is not None else None
        raw = self.net(self._net_input(z32), cond=cond, mask=mask, shift=True,
                       extra=extra)
        t, a, pi, mu, ls = self._split_raw(raw, z32.shape)
        y, elem_ldj = dispatch.mixture_forward(z32, pi, mu, ls)
        out = (1.0 - m) * (y * torch.exp(a) + t) + m * z32
        return out, ldj + sum_ldj((elem_ldj + a) * (1.0 - m), mask)

    def inverse(self, z, ldj, *, cond=None, mask=None):
        B, T, D = z.shape
        z32 = nm.at_least_f32(z)
        m = self._chan_mask(z32)
        if cond is not None:
            cond = cond.expand(B, T, cond.shape[-1])
        carry = self.net.init_carry(B, z32.device)
        # at t = 0 the net sees zeros, as the forward's shift gives it
        inp = z32.new_zeros(B, D + self.input_feats)
        xs, per = [], []
        for step in range(T):
            y_t = z32[:, step]
            # the masked-in channels pass through: z_t * m == y_t * m
            extra_t = y_t * m if self.parity is not None else None
            carry, raw = self.net.step(
                carry, inp, None if cond is None else cond[:, step], extra_t)
            t, a, pi, mu, ls = self._split_raw(raw, (B, D))
            u = (y_t - t) * torch.exp(-a)
            x_inv = dispatch.mixture_inverse(u, pi, mu, ls)
            x_t = (1.0 - m) * x_inv + m * y_t
            _, elem_ldj = dispatch.mixture_forward(x_inv, pi, mu, ls)
            per.append(((elem_ldj + a) * (1.0 - m)).sum(dim=-1))
            xs.append(x_t)
            inp = self._net_input(x_t)
        return (torch.stack(xs, dim=1),
                ldj - sum_ldj(torch.stack(per, dim=1), mask))
