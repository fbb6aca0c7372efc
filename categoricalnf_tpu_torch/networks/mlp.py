"""Per-position MLP coupling network, no mixing across positions.

Counterpart of ``categoricalnf_tpu/networks/mlp.py``: ``concat_cond``, then
``num_layers`` hidden dense layers with a tanh gelu after each and a
zero-initialised output layer.  The layers are the module's children
``0 .. num_layers``, as the reference's tuple of dense parameters is
indexed.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from categoricalnf_tpu_torch.networks.common import (Dense, concat_cond,
                                                     torch_dtype)


class MLP(nn.ModuleList):
    def __init__(self, in_dim: int, out_dim: int, cond_dim: int = 0, *,
                 hidden_dim: int = 128, num_layers: int = 2,
                 compute_dtype: str = "bfloat16", generator=None):
        dims = [in_dim + cond_dim] + [hidden_dim] * num_layers + [out_dim]
        super().__init__(
            Dense(dims[i], dims[i + 1], zero=i == len(dims) - 2,
                  generator=generator) for i in range(len(dims) - 1))
        self.compute_dtype = compute_dtype

    def forward(self, x, cond=None, mask=None):
        cd = torch_dtype(self.compute_dtype)
        h = concat_cond(x, cond)
        for i, layer in enumerate(self):
            h = layer(h, cd)
            if i < len(self) - 1:
                h = F.gelu(h, approximate="tanh")
        return h
