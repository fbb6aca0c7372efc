"""Variational dequantization encoding (the ordinal baseline).

Counterpart of ``categoricalnf_tpu/encodings/dequantization.py``: z = x + u
with u in (0, 1) drawn from a flow q(u|x) conditioned on the category's
embedding; the decoder rounds down (log p(x|z) = 0 on the unit cell).  The
flow maps u to the logistic base through a logit and ``num_blocks`` pairs
of a conditional affine and a checker-masked mixture-CDF coupling with an
MLP net; ``encode`` runs it backwards from the base noise, under grad when
training (on the card: #1 and its backward #1').  dim is always 1.
"""

from __future__ import annotations

import torch
from torch import nn

from categoricalnf_tpu_torch.encodings.base import Encoding
from categoricalnf_tpu_torch.flows.cond_affine import ConditionalAffine
from categoricalnf_tpu_torch.flows.coupling import MixtureCDFCoupling
from categoricalnf_tpu_torch.flows.model import FlowModel
from categoricalnf_tpu_torch.flows.sigmoid import Logit
from categoricalnf_tpu_torch.networks.mlp import MLP


class VariationalDequantization(Encoding):
    def __init__(self, num_categories: int, dim: int = 1, *,
                 embed_dim: int = 16, num_blocks: int = 2,
                 hidden_dim: int = 64, num_mixtures: int = 4,
                 compute_dtype: str = "float32", generator=None):
        super().__init__(num_categories, 1)
        self.embed = nn.Parameter(torch.randn(
            num_categories, embed_dim, generator=generator) * 0.5)
        layers = [Logit()]
        for parity in range(num_blocks):
            net = MLP(1, 2 + 3 * num_mixtures, embed_dim,
                      hidden_dim=hidden_dim, num_layers=2,
                      compute_dtype=compute_dtype, generator=generator)
            layers += [ConditionalAffine(1, embed_dim, generator=generator),
                       MixtureCDFCoupling(net, 1, parity=parity % 2,
                                          num_mixtures=num_mixtures,
                                          mask_kind="checker",
                                          generator=generator)]
        self.flow = FlowModel(layers)

    def encode(self, x, *, mask=None, generator=None, noise=None):
        emb = self.embed[x]
        eps = self.flow.prior.sample((*x.shape, 1), generator=generator,
                                     noise=noise, device=emb.device)
        u, ldj_inv = self.flow.inverse(eps, cond=emb, mask=mask)
        log_q = self.flow.prior.log_prob(eps, mask) - ldj_inv
        z = x.float()[..., None] + u.clamp(1e-5, 1.0 - 1e-5)
        return z, log_q

    def log_decoder(self, x, z, *, mask=None):
        return z.new_zeros(z.shape[0], dtype=torch.float32)

    def decode(self, z, *, mask=None):
        return torch.floor(z[..., 0]).long().clamp(0, self.num_categories - 1)
