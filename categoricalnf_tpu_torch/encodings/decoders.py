"""Learned decoders, the ablation beside the Bayes posterior decoder.

Counterpart of ``categoricalnf_tpu/encodings/decoders.py``: p(x|z) is an
independent softmax at each position over a dense layer (``LinearDecoder``)
or a one-hidden-layer tanh-gelu net (``MLPDecoder``) of z, in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from categoricalnf_tpu_torch.flows.base import sum_ldj
from categoricalnf_tpu_torch.networks.common import Dense
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


class _Decoder(nn.Module):
    def logits(self, z):
        raise NotImplementedError

    def log_prob(self, x, z, *, mask=None):
        logp = torch.log_softmax(self.logits(z), dim=-1)
        return sum_ldj(logp.gather(-1, x[..., None].long())[..., 0], mask)

    def decode(self, z):
        return self.logits(z).argmax(dim=-1)


class LinearDecoder(_Decoder):
    def __init__(self, num_categories: int, dim: int, *, generator=None):
        super().__init__()
        self.out = Dense(dim, num_categories, generator=generator)

    def logits(self, z):
        return self.out(at_least_f32(z), torch.float32)


class MLPDecoder(_Decoder):
    def __init__(self, num_categories: int, dim: int, hidden_dim: int = 64, *,
                 generator=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, generator=generator)
        self.out = Dense(hidden_dim, num_categories, generator=generator)

    def logits(self, z):
        h = F.gelu(self.fc1(at_least_f32(z), torch.float32),
                   approximate="tanh")
        return self.out(h, torch.float32)


def create_decoder(name: str, num_categories: int, dim: int, **kw):
    if name == "linear":
        return LinearDecoder(num_categories, dim, **kw)
    if name == "mlp":
        return MLPDecoder(num_categories, dim, **kw)
    raise ValueError(f"unknown decoder {name!r}")
