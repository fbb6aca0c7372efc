"""Mixture-model encoding with the Bayes decoder.

Counterpart of ``categoricalnf_tpu/encodings/mixture.py``: each category c
owns a factorized logistic q(z|c); the decoder is the Bayes posterior
p(c|z) = p~(c) q(z|c) / sum_c' p~(c') q(z|c') with a learned prior p~, or,
with ``decoder`` "linear" or "mlp", a learned decoder
(``encodings/decoders.py``) held as the ``decoder`` submodule.
"""

from __future__ import annotations

import torch
from torch import nn

from categoricalnf_tpu_torch.encodings.base import Encoding
from categoricalnf_tpu_torch.encodings.decoders import create_decoder
from categoricalnf_tpu_torch.flows.base import sum_ldj
from categoricalnf_tpu_torch.ops import numerics as nm


class MixtureEncoding(Encoding):
    def __init__(self, num_categories: int, dim: int = 2, *,
                 init_scale: float = 1.0, init_log_sigma: float = -2.0,
                 min_log_sigma: float = -4.6, max_log_sigma: float = 2.3,
                 decoder: str = "bayes", generator=None):
        super().__init__(num_categories, dim)
        # The lower clip keeps q(z|x) wider than fp32 resolution.
        self.min_log_sigma = min_log_sigma
        self.max_log_sigma = max_log_sigma
        self.means = nn.Parameter(
            torch.randn(num_categories, dim, generator=generator) * init_scale)
        self.log_scales = nn.Parameter(
            torch.full((num_categories, dim), init_log_sigma))
        self.prior_logits = nn.Parameter(torch.zeros(num_categories))
        self.decoder = (None if decoder == "bayes" else create_decoder(
            decoder, num_categories, dim, generator=generator))

    def _ls(self, raw):
        return raw.clamp(self.min_log_sigma, self.max_log_sigma)

    def encode(self, x, *, mask=None, generator=None, noise=None):
        mu = self.means[x]
        ls = self._ls(self.log_scales[x])
        z = nm.logistic_sample(mu.shape, mu, ls, generator=generator,
                               noise=noise, device=mu.device)
        return z, sum_ldj(nm.logistic_log_pdf(z, mu, ls), mask)

    def _log_joint_all(self, z):
        """log p~(c) + log q(z|c) for all categories: [B, T, C]."""
        comp = nm.logistic_log_pdf(z[..., None, :], self.means,
                                   self._ls(self.log_scales)).sum(-1)
        return comp + torch.log_softmax(self.prior_logits, dim=-1)

    def log_decoder(self, x, z, *, mask=None):
        if self.decoder is not None:
            return self.decoder.log_prob(x, z, mask=mask)
        log_joint = self._log_joint_all(z)
        log_norm = torch.logsumexp(log_joint, dim=-1)
        log_post = log_joint.gather(-1, x[..., None].long())[..., 0]
        return sum_ldj(log_post - log_norm, mask)

    def decode(self, z, *, mask=None):
        if self.decoder is not None:
            return self.decoder.decode(z)
        return self._log_joint_all(z).argmax(dim=-1)

    def posterior(self, z):
        """The Bayes posterior p(x|z) over all categories: [B, T, C]."""
        return torch.softmax(self._log_joint_all(z), dim=-1)
