"""Linear-flows encoding: per-category distributions by conditional flows.

Counterpart of ``categoricalnf_tpu/encodings/linear_flows.py``: q(z|c) is a
standard logistic pushed through a small flow conditioned on c's
embedding, and the decoder is the Bayes posterior over a learned prior.
Positions are independent under the encoding, so [B, T] is one batch axis
of rows [B*T, 1, D] around every flow call.  The decoder evaluates the
flow once for every category: the K categories are folded into that axis
as one call of K*B*T rows (the reference maps over them with ``vmap``).
"""

from __future__ import annotations

import torch
from torch import nn

from categoricalnf_tpu_torch.encodings.base import Encoding
from categoricalnf_tpu_torch.flows.base import sum_ldj
from categoricalnf_tpu_torch.flows.cond_affine import ConditionalAffine
from categoricalnf_tpu_torch.flows.coupling import MixtureCDFCoupling
from categoricalnf_tpu_torch.flows.linear import InvertibleLinear
from categoricalnf_tpu_torch.flows.model import FlowModel
from categoricalnf_tpu_torch.flows.softclamp import SoftClamp
from categoricalnf_tpu_torch.networks.mlp import MLP


def default_encoding_flow(dim: int, cond_dim: int, num_blocks: int = 2,
                          hidden_dim: int = 64, num_mixtures: int = 4,
                          compute_dtype: str = "float32", *,
                          generator=None) -> FlowModel:
    """num_blocks x [InvertibleLinear, ConditionalAffine, two channel
    mixture-CDF couplings (parities 0 and 1, an MLP net each), SoftClamp]."""
    def coupling(parity):
        net = MLP(dim, dim * (2 + 3 * num_mixtures), cond_dim,
                  hidden_dim=hidden_dim, num_layers=2,
                  compute_dtype=compute_dtype, generator=generator)
        return MixtureCDFCoupling(net, dim, parity=parity,
                                  num_mixtures=num_mixtures,
                                  generator=generator)

    layers = []
    for _ in range(num_blocks):
        layers += [InvertibleLinear(dim, generator=generator),
                   ConditionalAffine(dim, cond_dim, generator=generator),
                   coupling(0), coupling(1), SoftClamp()]
    return FlowModel(layers)


class LinearFlowEncoding(Encoding):
    def __init__(self, num_categories: int, dim: int = 2, *,
                 embed_dim: int = 16, num_blocks: int = 2,
                 hidden_dim: int = 64, num_mixtures: int = 4,
                 compute_dtype: str = "float32", generator=None):
        super().__init__(num_categories, dim)
        self.embed = nn.Parameter(torch.randn(
            num_categories, embed_dim, generator=generator) * 0.5)
        self.flow = default_encoding_flow(dim, embed_dim, num_blocks,
                                          hidden_dim, num_mixtures,
                                          compute_dtype, generator=generator)
        self.prior_logits = nn.Parameter(torch.zeros(num_categories))

    def encode(self, x, *, mask=None, generator=None, noise=None):
        B, T = x.shape
        emb = self.embed[x].reshape(B * T, 1, -1)
        if noise is not None:
            noise = noise.reshape(B * T, 1, self.dim)
        eps = self.flow.prior.sample((B * T, 1, self.dim),
                                     generator=generator, noise=noise,
                                     device=emb.device)
        z, ldj_inv = self.flow.inverse(eps, cond=emb)
        log_q = (self.flow.prior.log_prob(eps) - ldj_inv).reshape(B, T)
        return z.reshape(B, T, self.dim), sum_ldj(log_q, mask)

    def _log_joint_all(self, z):
        """log p~(c) + log q(z_t|c) for every category c: [B, T, K], from
        one flow call over the K*B*T rows (category-major)."""
        B, T, D = z.shape
        K = self.num_categories
        rows = z.reshape(1, B * T, 1, D).expand(K, -1, -1, -1)
        cond = self.embed[:, None, None, :].expand(-1, B * T, -1, -1)
        eps, ldj = self.flow(rows.reshape(K * B * T, 1, D),
                             cond=cond.reshape(K * B * T, 1, -1))
        log_q = (self.flow.prior.log_prob(eps) + ldj).reshape(K, B, T)
        return (log_q.permute(1, 2, 0)
                + torch.log_softmax(self.prior_logits, dim=-1))

    def log_decoder(self, x, z, *, mask=None):
        log_joint = self._log_joint_all(z)
        log_post = (log_joint.gather(-1, x[..., None].long())[..., 0]
                    - torch.logsumexp(log_joint, dim=-1))
        return sum_ldj(log_post, mask)

    def decode(self, z, *, mask=None):
        return self._log_joint_all(z).argmax(dim=-1)
