"""Encoding protocol: categorical x <-> continuous z.

Counterpart of ``categoricalnf_tpu/encodings/base.py``.  x is int ``[B, T]``,
z fp32 ``[B, T, D]``, log-probs ``[B]`` (masked sums over positions).
"""

from __future__ import annotations

from torch import nn


class Encoding(nn.Module):
    def __init__(self, num_categories: int, dim: int):
        super().__init__()
        self.num_categories = num_categories
        self.dim = dim

    def encode(self, x, *, mask=None, generator=None, noise=None):
        """Sample z ~ q(z|x); return (z, log q(z|x))."""
        raise NotImplementedError

    def log_decoder(self, x, z, *, mask=None):
        """log p(x|z) per batch element."""
        raise NotImplementedError

    def decode(self, z, *, mask=None):
        """The most likely categories for z."""
        raise NotImplementedError
