"""GraphCNF: the three-stage flow of molecule generation.

Counterpart of ``categoricalnf_tpu/models/graphcnf.py``.  Three latent
streams, each conditioned only on data-side latents of the stages before
it, so that the density (forward) and sampling (inverse) directions see the
same conditions:

  1. node types z_v [B, N, Dv]: couplings whose net is a SetTransformer
     over the nodes under the node mask (on the card, the fused kernels with
     the key mask);
  2. edge existence z_e1 [B, E, D1] (E = N(N-1)/2 upper-triangular pairs,
     categories {virtual, real}): EdgeGNN couplings conditioned on z_v;
  3. bond types z_e2 [B, E, D2] (single, double, triple) on the existing
     edges only: EdgeGNN couplings conditioned on z_v and on z_e1 as edge
     features.

Graphs of every size are padded to ``max_nodes`` and masked; the node-count
prior belongs to the task.  Every method that draws noise takes a
``torch.Generator`` and an optional ``noise``, a tuple of the three stages'
uniform draws (node, existence, bond), so tests can feed both frameworks the
same numbers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from categoricalnf_tpu_torch import flows
from categoricalnf_tpu_torch.encodings import MixtureEncoding
from categoricalnf_tpu_torch.networks.graph import (EdgeGNN,
                                                    incidence_matrix,
                                                    pair_indices)
from categoricalnf_tpu_torch.networks.transformer import SetTransformer
from categoricalnf_tpu_torch.ops.numerics import at_least_f32

LN2 = 0.6931471805599453


def build_node_flow(dim: int, num_layers: int, hidden_dim: int,
                    num_mixtures: int, compute_dtype: str, *,
                    generator=None) -> flows.FlowModel:
    """The node stage's couplings, SetTransformer nets over the nodes.  As
    every stage's, scanned with ``remat`` at an even depth of at least 4:
    the graph nets' activations are the largest."""
    out_dim = dim * (2 + 3 * num_mixtures)
    return flows.coupling_stack(
        lambda: SetTransformer(dim, out_dim, hidden_dim=hidden_dim,
                               num_heads=4, num_layers=2,
                               compute_dtype=compute_dtype,
                               generator=generator),
        dim, num_layers, num_mixtures, remat=True, generator=generator)


def build_edge_flow(dim: int, cond_dim: int, max_nodes: int,
                    edge_feat_dim: int, num_layers: int, hidden_dim: int,
                    num_mixtures: int, compute_dtype: str,
                    degree_norm: str = "nodes", *,
                    generator=None) -> flows.FlowModel:
    """An edge stage's couplings, EdgeGNN nets over the node pairs."""
    out_dim = dim * (2 + 3 * num_mixtures)
    return flows.coupling_stack(
        lambda: EdgeGNN(dim, out_dim, cond_dim, num_nodes=max_nodes,
                        hidden_dim=hidden_dim, num_layers=2,
                        edge_feat_dim=edge_feat_dim, degree_norm=degree_norm,
                        compute_dtype=compute_dtype, generator=generator),
        dim, num_layers, num_mixtures, remat=True, generator=generator)


class GraphCNF(nn.Module):
    """The levers are the reference's: ``num_layers_bond`` (0 follows
    ``num_layers_edge``), ``edge_degree_norm``, ``bond_cond_exist`` (the
    decoded existence one-hots as bond-stage edge features),
    ``node_cond_atoms`` (stages 2-3 see the decoded atom one-hots beside
    z_v) and ``bond_cond_degree`` (the bond stage's nodes see their decoded
    degree, one-hot, clipped at 5)."""

    def __init__(self, *, num_atom_types: int = 9, num_bond_types: int = 3,
                 max_nodes: int = 38, node_dim: int = 6, exist_dim: int = 2,
                 bond_dim: int = 3, num_layers_node: int = 4,
                 num_layers_edge: int = 4, num_layers_bond: int = 0,
                 hidden_dim: int = 96, num_mixtures: int = 8,
                 edge_degree_norm: str = "nodes",
                 bond_cond_exist: bool = False,
                 node_cond_atoms: bool = False,
                 bond_cond_degree: bool = False,
                 compute_dtype: str = "float32", generator=None):
        super().__init__()
        self.num_atom_types = num_atom_types
        self.max_nodes = max_nodes
        self.node_dim, self.exist_dim, self.bond_dim = (node_dim, exist_dim,
                                                        bond_dim)
        self.bond_cond_exist = bond_cond_exist
        self.node_cond_atoms = node_cond_atoms
        self.bond_cond_degree = bond_cond_degree
        g = generator
        self.enc_node = MixtureEncoding(num_atom_types, node_dim, generator=g)
        self.enc_exist = MixtureEncoding(2, exist_dim, generator=g)
        self.enc_bond = MixtureEncoding(num_bond_types, bond_dim, generator=g)
        cond_node = node_dim + (num_atom_types if node_cond_atoms else 0)
        self.flow_node = build_node_flow(node_dim, num_layers_node,
                                         hidden_dim, num_mixtures,
                                         compute_dtype, generator=g)
        self.flow_exist = build_edge_flow(
            exist_dim, cond_node, max_nodes, 0, num_layers_edge, hidden_dim,
            num_mixtures, compute_dtype, edge_degree_norm, generator=g)
        self.flow_bond = build_edge_flow(
            bond_dim, cond_node + (6 if bond_cond_degree else 0), max_nodes,
            exist_dim + (2 if bond_cond_exist else 0),
            num_layers_bond or num_layers_edge, hidden_dim, num_mixtures,
            compute_dtype, edge_degree_norm, generator=g)

    @property
    def num_edges(self) -> int:
        return self.max_nodes * (self.max_nodes - 1) // 2

    def edge_mask(self, node_mask):
        ii, jj = pair_indices(self.max_nodes, node_mask.device)
        return node_mask[:, ii] * node_mask[:, jj]

    def num_vars(self, node_mask):
        return (at_least_f32(node_mask).sum(-1)
                + at_least_f32(self.edge_mask(node_mask)).sum(-1))

    # -- the stages' conditions --------------------------------------------

    def _node_feat(self, z_v, atoms, node_mask):
        """Stages 2-3's node features: z_v, and with ``node_cond_atoms`` the
        atom one-hots (data labels in the density direction, the decoded
        stage-1 atoms when sampling), zero on padded nodes."""
        if not self.node_cond_atoms:
            return z_v
        oh = F.one_hot(atoms.long(), self.num_atom_types).float()
        oh = oh * at_least_f32(node_mask)[..., None]
        return torch.cat([at_least_f32(z_v), oh], dim=-1)

    def _bond_node_feat(self, node_feat, exist, e_mask, node_mask):
        """The bond stage's node features: with ``bond_cond_degree`` the
        one-hot of each node's count of existing edges, clipped at 5."""
        if not self.bond_cond_degree:
            return node_feat
        inc = incidence_matrix(self.max_nodes, e_mask.device)
        live = exist.float() * at_least_f32(e_mask)
        deg = live @ inc                                   # [B, N]
        oh = F.one_hot(deg.clamp(0, 5).long(), 6).float()
        oh = oh * at_least_f32(node_mask)[..., None]
        return torch.cat([node_feat, oh], dim=-1)

    def _bond_edge_feat(self, z_e1, exist, e_mask):
        """The bond stage's edge features: z_e1, and with ``bond_cond_exist``
        the existence one-hots, zero on padded pairs."""
        if not self.bond_cond_exist:
            return z_e1
        oh = F.one_hot(exist.long(), 2).float()
        oh = oh * at_least_f32(e_mask)[..., None]
        return torch.cat([at_least_f32(z_e1), oh], dim=-1)

    def _conds(self, z_v, z_e1, atoms, exist, e_mask, node_mask):
        node_feat = self._node_feat(z_v, atoms, node_mask)
        cond_e1 = {"node_feat": node_feat, "node_mask": node_mask}
        cond_e2 = {"node_feat": self._bond_node_feat(node_feat, exist,
                                                     e_mask, node_mask),
                   "node_mask": node_mask,
                   "edge_feat": self._bond_edge_feat(z_e1, exist, e_mask)}
        return cond_e1, cond_e2

    def _split(self, edges, node_mask):
        e_mask = self.edge_mask(node_mask)
        exist = (edges > 0).long()
        bond = (edges - 1).clamp_min(0).long()
        return e_mask, exist, bond, e_mask * exist.to(e_mask.dtype)

    def _encode(self, atoms, edges, node_mask, generator, noise):
        nv, ne1, ne2 = (None, None, None) if noise is None else noise
        e_mask, exist, bond, bond_mask = self._split(edges, node_mask)
        z_v, lq_v = self.enc_node.encode(atoms.long(), mask=node_mask,
                                         generator=generator, noise=nv)
        z_e1, lq_e1 = self.enc_exist.encode(exist, mask=e_mask,
                                            generator=generator, noise=ne1)
        z_e2, lq_e2 = self.enc_bond.encode(bond, mask=bond_mask,
                                           generator=generator, noise=ne2)
        return ((z_v, z_e1, z_e2), lq_v + lq_e1 + lq_e2,
                (e_mask, exist, bond, bond_mask))

    # -- objective -----------------------------------------------------------

    def elbo(self, atoms, edges, node_mask, *, generator=None, noise=None):
        """Single-sample ELBO parts, per graph.  atoms [B, N] in 0..A-1;
        edges [B, E] in 0 (virtual) and 1..R (bond types)."""
        (z_v, z_e1, z_e2), log_q, (e_mask, exist, bond, bond_mask) = \
            self._encode(atoms, edges, node_mask, generator, noise)
        cond_e1, cond_e2 = self._conds(z_v, z_e1, atoms, exist, e_mask,
                                       node_mask)
        log_p = (self.flow_node.log_prob(z_v, mask=node_mask)
                 + self.flow_exist.log_prob(z_e1, cond=cond_e1, mask=e_mask)
                 + self.flow_bond.log_prob(z_e2, cond=cond_e2,
                                           mask=bond_mask))
        log_dec = (self.enc_node.log_decoder(atoms.long(), z_v,
                                             mask=node_mask)
                   + self.enc_exist.log_decoder(exist, z_e1, mask=e_mask)
                   + self.enc_bond.log_decoder(bond, z_e2, mask=bond_mask))
        return {"elbo": log_p + log_dec - log_q, "log_p": log_p,
                "log_dec": log_dec, "log_q": log_q}

    def loss_bpd(self, atoms, edges, node_mask, beta=1.0, *, generator=None,
                 noise=None, batch_mean=None):
        """Mean bits/variable of the beta-annealed ELBO with the reference's
        positive-ELBO guard and its ``batch_mean``
        (``CategoricalFlow.loss_bpd``); a graph's variables are its nodes
        and its node pairs."""
        parts = self.elbo(atoms, edges, node_mask, generator=generator,
                          noise=noise)
        obj = parts["log_p"] + parts["log_dec"] - beta * parts["log_q"]
        n = self.num_vars(node_mask)
        loss = torch.mean(-obj / (n * LN2))
        cheat = torch.relu((batch_mean or torch.mean)(parts["elbo"]
                                                      / (n * LN2)))
        return loss + 10.0 * cheat * cheat

    def iw_log_prob(self, atoms, edges, node_mask, num_samples: int, *,
                    generator=None, noise=None):
        """Importance-sampled log p [B]; chains run as a batch dimension,
        16 at a time.  ``noise``, if given, is the stages' uniforms with a
        leading chain axis: ([S, B, N, Dv], [S, B, E, D1], [S, B, E, D2])."""
        B = atoms.shape[0]
        chunk = num_samples if num_samples % 16 else 16
        elbos = []
        for s0 in range(0, num_samples, chunk):
            c = min(chunk, num_samples - s0)
            nz = None if noise is None else tuple(
                u[s0:s0 + c].reshape(c * B, *u.shape[2:]) for u in noise)
            tile = lambda t: t.repeat(c, *([1] * (t.dim() - 1)))
            e = self.elbo(tile(atoms), tile(edges), tile(node_mask),
                          generator=generator, noise=nz)["elbo"]
            elbos.append(e.reshape(c, B))
        return (torch.logsumexp(torch.cat(elbos), dim=0)
                - math.log(num_samples))

    def eval_bpd(self, atoms, edges, node_mask, num_samples: int = 1, *,
                 generator=None, noise=None):
        ll = self.iw_log_prob(atoms, edges, node_mask, num_samples,
                              generator=generator, noise=noise)
        return -ll / (self.num_vars(node_mask) * LN2)

    # -- sampling -------------------------------------------------------------

    def sample(self, node_mask, temperature=1.0, *, generator=None,
               noise=None):
        """Ancestral samples given a node mask: (atoms [B, N], edges [B, E]
        with 0 = virtual and 1..R the bond type).  ``temperature`` scales
        the prior draws: a scalar for all three stages, or (t_node, t_exist,
        t_bond).  ``noise``: the three stages' prior uniforms.  The bond
        stage's inverse runs under bond_mask = e_mask * exist, the mask its
        density is evaluated under."""
        st = self.sample_stages(node_mask, temperature, generator=generator,
                                noise=noise)
        e_mask = self.edge_mask(node_mask)
        edges = (st["exist"] * (1 + st["bond"]) * e_mask).long()
        atoms = (st["atoms"] * node_mask).long()
        return atoms, edges

    def sample_stages(self, node_mask, temperature=1.0, *, generator=None,
                      noise=None, given=None):
        """``sample``'s stages before their assembly: each stage's latents
        and decoded categories, {"z_v", "atoms", "z_e1", "exist", "z_e2",
        "bond"}.  ``given``, if any, holds earlier stages' values (of these
        names) that the later stages are conditioned on in place of the
        sampled ones: bonds for given atoms and existence, or one stage of
        two runs compared on the same inputs."""
        B = node_mask.shape[0]
        temps = [float(t) for t in torch.as_tensor(
            temperature, dtype=torch.float32).reshape(-1).expand(3)]
        nv, ne1, ne2 = (None, None, None) if noise is None else noise
        given = given or {}
        dev = node_mask.device
        e_mask = self.edge_mask(node_mask)
        E = self.num_edges

        out = {"z_v": self.flow_node.sample(
            (B, self.max_nodes, self.node_dim), mask=node_mask,
            temperature=temps[0], generator=generator, noise=nv, device=dev)}
        out["atoms"] = self.enc_node.decode(out["z_v"])
        z_v = given.get("z_v", out["z_v"])
        atoms = given.get("atoms", out["atoms"])
        node_feat = self._node_feat(z_v, atoms, node_mask)
        out["z_e1"] = self.flow_exist.sample(
            (B, E, self.exist_dim),
            cond={"node_feat": node_feat, "node_mask": node_mask},
            mask=e_mask, temperature=temps[1], generator=generator,
            noise=ne1, device=dev)
        out["exist"] = self.enc_exist.decode(out["z_e1"])
        z_e1 = given.get("z_e1", out["z_e1"])
        exist = given.get("exist", out["exist"])
        bond_mask = e_mask * exist.to(e_mask.dtype)
        _, cond_e2 = self._conds(z_v, z_e1, atoms, exist, e_mask, node_mask)
        out["z_e2"] = self.flow_bond.sample(
            (B, E, self.bond_dim), cond=cond_e2, mask=bond_mask,
            temperature=temps[2], generator=generator, noise=ne2, device=dev)
        out["bond"] = self.enc_bond.decode(out["z_e2"])
        return out

    # -- data-dependent init --------------------------------------------------

    @torch.no_grad()
    def data_init(self, atoms, edges, node_mask, *, generator=None,
                  noise=None):
        """Calibration pass: each stage's ActNorm layers absorb the
        statistics of its latents, under that stage's condition and mask."""
        (z_v, z_e1, z_e2), _, (e_mask, exist, _, bond_mask) = self._encode(
            atoms, edges, node_mask, generator, noise)
        self.flow_node.data_init(z_v, mask=node_mask)
        cond_e1, cond_e2 = self._conds(z_v, z_e1, atoms, exist, e_mask,
                                       node_mask)
        self.flow_exist.data_init(z_e1, cond=cond_e1, mask=e_mask)
        self.flow_bond.data_init(z_e2, cond=cond_e2, mask=bond_mask)

