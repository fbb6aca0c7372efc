"""Relational GCN coupling network over dense adjacency (graph coloring).

Counterpart of ``_norm_adj`` and ``RGCN`` in
``categoricalnf_tpu/networks/graph.py``.  The adjacency rides in ``cond`` as
a dict, ``{"adj": [B, N, N]}`` or ``{"adj_r": [B, N, N, R]}`` (one-hot
relations), and message passing is a batched matmul over it.  Every
contraction multiplies compute-dtype operands with an fp32 sum (TF32 off),
as ``networks.common.dense`` does; the residual stream stays in the compute
dtype, as in the reference.  There is no kernel: on the card the net runs
in plain PyTorch, and its output feeds the mixture kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from categoricalnf_tpu_torch.networks.common import (Dense, layer_norm,
                                                     torch_dtype)
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


def norm_adj(adj: torch.Tensor, mask=None) -> torch.Tensor:
    """Symmetric degree normalisation D^-1/2 A D^-1/2 of the masked
    adjacency (fp32; float64 where ``adj`` is)."""
    adj = at_least_f32(adj)
    if mask is not None:
        m = mask.to(adj.dtype)
        adj = adj * m[:, :, None] * m[:, None, :]
    inv_sqrt = torch.rsqrt(adj.sum(-1).clamp_min(1e-6))
    return adj * inv_sqrt[:, :, None] * inv_sqrt[:, None, :]


class _Block(nn.Module):
    def __init__(self, h: int, num_relations: int, generator):
        super().__init__()
        # ``self`` is the reference's name for the node's own transform, so
        # that parameter names match its tree (blocks.<i>.self.w)
        self.self = Dense(h, h, scale=0.5, generator=generator)
        self.rel = nn.ModuleList(Dense(h, h, scale=0.5, generator=generator)
                                 for _ in range(num_relations))
        self.mlp = Dense(h, h, scale=0.5, generator=generator)


class RGCN(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, hidden_dim: int = 96,
                 num_layers: int = 3, num_relations: int = 1,
                 compute_dtype: str = "float32", generator=None):
        super().__init__()
        self.num_relations = num_relations
        self.compute_dtype = compute_dtype
        self.embed = Dense(in_dim, hidden_dim, generator=generator)
        self.out = Dense(hidden_dim, out_dim, zero=True, generator=generator)
        self.blocks = nn.ModuleList(
            _Block(hidden_dim, num_relations, generator)
            for _ in range(num_layers))

    def _adjs(self, cond, mask):
        if "adj_r" in cond:
            a = cond["adj_r"]
            return [norm_adj(a[..., r], mask)
                    for r in range(self.num_relations)]
        return [norm_adj(cond["adj"], mask)] * self.num_relations

    def forward(self, x, cond=None, mask=None):
        cd = torch_dtype(self.compute_dtype)
        adjs = self._adjs(cond, mask)
        h = self.embed(at_least_f32(x), cd)
        for blk in self.blocks:
            hn = layer_norm(h)
            msg = blk.self(hn, cd)
            for a, rel in zip(adjs, blk.rel):
                # compute-dtype operands, fp32 sum: a bf16 matmul would
                # round the sum over neighbours to bf16
                neigh = at_least_f32(a.to(cd)) @ at_least_f32(hn.to(cd))
                msg = msg + rel(neigh, cd)
            h = h + F.gelu(msg, approximate="tanh")
            h = h + blk.mlp(F.gelu(layer_norm(h), approximate="tanh"), cd)
        if mask is not None:
            h = h * mask.to(h.dtype)[..., None]
        return self.out(h, cd)
