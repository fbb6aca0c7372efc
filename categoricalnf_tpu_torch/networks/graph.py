"""Graph coupling networks over dense adjacency: the relational GCN (graph
coloring) and the Edge-GNN (GraphCNF's edge stages).

Counterpart of ``categoricalnf_tpu/networks/graph.py``.  The RGCN's
adjacency rides in ``cond`` as a dict, ``{"adj": [B, N, N]}`` or
``{"adj_r": [B, N, N, R]}`` (one-hot relations), and message passing is a
batched matmul over it.  The Edge-GNN reads and writes the flattened
upper-triangular edge stream [B, E, C] (E = N(N-1)/2) and aggregates edges
into nodes through the static incidence matrix.  Every contraction
multiplies compute-dtype operands with an fp32 sum (TF32 off), as
``networks.common.dense`` does; the streams keep the reference's dtypes
(its promotions of a bf16 stream times an fp32 mask included).  There is no
kernel: on the card the nets run in plain PyTorch, and their output feeds
the mixture kernels.
"""

from __future__ import annotations

import numpy as np
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


_STATIC: dict = {}


def pair_indices(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The upper-triangular pairs (i < j) of ``n`` nodes in row order, as
    two long tensors of length E = n(n-1)/2."""
    key = ("pairs", n, str(device))
    if key not in _STATIC:
        iu = np.triu_indices(n, k=1)
        _STATIC[key] = tuple(torch.as_tensor(v, dtype=torch.long,
                                             device=device) for v in iu)
    return _STATIC[key]


def incidence_matrix(n: int, device=None) -> torch.Tensor:
    """The [E, N] 0/1 incidence of the pairs: row e has ones at its two
    endpoints.  Edge-to-node aggregation is a matmul with its transpose."""
    key = ("inc", n, str(device))
    if key not in _STATIC:
        iu = np.triu_indices(n, k=1)
        E = len(iu[0])
        inc = np.zeros((E, n), np.float32)
        inc[np.arange(E), iu[0]] = 1.0
        inc[np.arange(E), iu[1]] = 1.0
        _STATIC[key] = torch.as_tensor(inc, device=device)
    return _STATIC[key]


class _EdgeBlock(nn.Module):
    def __init__(self, h: int, generator):
        super().__init__()
        self.v2e = Dense(2 * h, h, scale=0.5, generator=generator)
        self.e2v = Dense(h, h, scale=0.5, generator=generator)
        self.v_mlp = Dense(h, h, scale=0.5, generator=generator)
        self.e_mlp = Dense(h, h, scale=0.5, generator=generator)


class EdgeGNN(nn.Module):
    """Joint node and edge message passing whose input and output are edge
    features: x [B, E, in_dim] -> [B, E, out_dim].

    ``cond``: ``{"node_feat": [B, N, cond_dim]}``, optionally
    ``"node_mask"`` [B, N] and, with ``edge_feat_dim``, ``"edge_feat"``
    [B, E, edge_feat_dim] (modelled latents, not masked).  ``degree_norm``
    divides the edge-to-node sum by N_live - 1 (``"nodes"``) or by the
    node's live-edge count (``"live_edges"``).  ``mask`` is the transform's
    validity mask over edges and gates every read of ``x``: positions
    outside it are excluded from the density, so their values must not
    reach valid positions."""

    def __init__(self, in_dim: int, out_dim: int, cond_dim: int = 0, *,
                 num_nodes: int, hidden_dim: int = 96, num_layers: int = 3,
                 edge_feat_dim: int = 0, degree_norm: str = "nodes",
                 compute_dtype: str = "float32", generator=None):
        super().__init__()
        if degree_norm not in ("nodes", "live_edges"):
            raise ValueError(f"unknown degree_norm {degree_norm!r}")
        h = hidden_dim
        self.num_nodes = num_nodes
        self.edge_feat_dim = edge_feat_dim
        self.degree_norm = degree_norm
        self.compute_dtype = compute_dtype
        self.embed_e = Dense(in_dim + edge_feat_dim, h, generator=generator)
        self.embed_v = Dense(cond_dim if cond_dim else 1, h,
                             generator=generator)
        self.out = Dense(h, out_dim, zero=True, generator=generator)
        self.blocks = nn.ModuleList(_EdgeBlock(h, generator)
                                    for _ in range(num_layers))

    def forward(self, x, cond=None, mask=None):
        cd = torch_dtype(self.compute_dtype)
        B, n = x.shape[0], self.num_nodes
        ii, jj = pair_indices(n, x.device)
        node_feat = at_least_f32(cond["node_feat"])
        node_mask = cond.get("node_mask")
        vmask = (at_least_f32(node_mask) if node_mask is not None
                 else node_feat.new_ones(B, n))
        emask = vmask[:, ii] * vmask[:, jj]            # [B, E]
        if mask is not None:
            emask = emask * at_least_f32(mask)
        em = emask[..., None]

        x = at_least_f32(x) * em
        if self.edge_feat_dim:
            x = torch.cat([x, at_least_f32(cond["edge_feat"])], dim=-1)
        he = self.embed_e(x, cd)                       # [B, E, H]
        hv = self.embed_v(node_feat, cd)               # [B, N, H]
        inc = incidence_matrix(n, x.device)
        inc_t = at_least_f32(inc.to(cd)).t()           # [N, E]
        if self.degree_norm == "live_edges":
            deg = (emask @ inc).clamp_min(1.0)[..., None]          # [B, N, 1]
        else:
            deg = (vmask.sum(-1, keepdim=True) - 1.0).clamp_min(1.0)[..., None]
        for blk in self.blocks:
            hv_n, he_n = layer_norm(hv), layer_norm(he)
            # the edge update: the edge and its two endpoints
            ends = torch.cat([hv_n[:, ii], hv_n[:, jj]], dim=-1)
            he = he + F.gelu(blk.v2e(ends, cd) + he_n,
                             approximate="tanh") * em
            # the node update: incidence-matmul aggregation, compute-dtype
            # operands with an fp32 sum
            he_m = blk.e2v(layer_norm(he), cd) * em
            agg = inc_t @ at_least_f32(he_m.to(cd))
            hv = hv + F.gelu(agg / deg, approximate="tanh")
            hv = hv + blk.v_mlp(F.gelu(layer_norm(hv), approximate="tanh"),
                                cd)
            he = he + blk.e_mlp(F.gelu(layer_norm(he), approximate="tanh"),
                                cd)
        return self.out(he, cd)
