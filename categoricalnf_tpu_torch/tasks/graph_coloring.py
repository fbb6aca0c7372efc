"""Graph 3-coloring task (counterpart of
``categoricalnf_tpu/tasks/graph_coloring.py``).

A generator of random graphs with planted valid colorings, a conditional
flow p(colors | graph) whose coupling nets are RGCNs over the adjacency, and
the validity rate of sampled colorings.  Graphs of ``min_nodes`` to
``max_nodes`` nodes are padded to ``max_nodes`` with a node mask; the
adjacency rides through the model as ``cond={"adj": [B, N, N]}``.  The
generator, the validity check and the repair pass are numpy, the port's own
copies of the reference's, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from categoricalnf_tpu_torch import flows
from categoricalnf_tpu_torch.encodings import MixtureEncoding
from categoricalnf_tpu_torch.models.categorical_flow import CategoricalFlow
from categoricalnf_tpu_torch.networks import RGCN
from categoricalnf_tpu_torch.training.task import TaskTemplate
from categoricalnf_tpu_torch.utils.device import resolve_device


def random_colorable_graph(rng: np.random.Generator, num_nodes: int,
                           num_colors: int = 3, edge_prob: float = 0.25):
    """Random graph k-colorable by construction: hidden colors first, then
    edges only between nodes of distinct colors; a random permutation of
    the colors de-biases the labels.  Returns (adj, colors)."""
    colors = rng.integers(0, num_colors, num_nodes)
    adj = np.zeros((num_nodes, num_nodes), np.float32)
    for i in range(num_nodes):
        for j in range(i + 1, num_nodes):
            if colors[i] != colors[j] and rng.random() < edge_prob:
                adj[i, j] = adj[j, i] = 1.0
    perm = rng.permutation(num_colors)
    return adj, perm[colors].astype(np.int32)


def coloring_validity(adj: np.ndarray, colors: np.ndarray,
                      mask: np.ndarray) -> np.ndarray:
    """Per-graph bool: no edge joins equal colors (padded nodes ignored)."""
    same = (colors[:, :, None] == colors[:, None, :]).astype(np.float32)
    m2 = mask[:, :, None] * mask[:, None, :]
    viol = (adj * same * m2).sum(axis=(1, 2))
    return viol == 0


def repair_coloring(adj: np.ndarray, probs: np.ndarray, colors: np.ndarray,
                    mask: np.ndarray, max_sweeps: int = 50,
                    seed: int = 0) -> np.ndarray:
    """Constraint-aware repair of sampled colorings, ranked by the
    encoding's posterior ``probs`` [B, N, K]; never touches the flow.

    1. One ordered greedy pass: a node whose color conflicts with an
       already-visited neighbour moves to its most probable color that
       those neighbours do not use.
    2. Min-conflicts sweeps: each conflicted node moves to the color with
       the fewest conflicts (the posterior breaks ties); a sweep that
       changes nothing re-randomizes one conflicted node (a generator
       seeded ``seed``), up to ``max_sweeps`` sweeps.

    A stuck sample keeps its conflicts: validity is measured again on the
    output, never assumed."""
    esc_rng = np.random.default_rng(seed)
    out = colors.copy()
    B, N = colors.shape
    K = probs.shape[-1]
    order_all = np.argsort(-probs, axis=-1)           # [B, N, K]
    for b in range(B):
        nbr = adj[b] > 0
        live = mask[b] > 0
        for i in range(N):
            if not live[i]:
                continue
            earlier = nbr[i, :i] & live[:i]
            if not earlier.any():
                continue
            used = set(out[b, :i][earlier].tolist())
            if out[b, i] in used:
                for c in order_all[b, i]:
                    if int(c) not in used:
                        out[b, i] = c
                        break
        for _ in range(max_sweeps):
            changed = False
            conflicted = []
            for i in range(N):
                if not live[i]:
                    continue
                nb = nbr[i] & live
                if not nb.any():
                    continue
                nb_colors = out[b, nb]
                cur = (nb_colors == out[b, i]).sum()
                if cur == 0:
                    continue
                conflicted.append(i)
                conf = np.array([(nb_colors == c).sum() for c in range(K)])
                best = min(range(K),
                           key=lambda c: (conf[c], -probs[b, i, c]))
                if conf[best] < cur:
                    out[b, i] = best
                    changed = True
            if not conflicted:
                break
            if not changed:
                i = conflicted[int(esc_rng.integers(len(conflicted)))]
                out[b, i] = (out[b, i] + 1
                             + int(esc_rng.integers(K - 1))) % K
    return out


def build_coloring_flow(dim: int, num_layers: int = 6, hidden_dim: int = 96,
                        num_mixtures: int = 8,
                        compute_dtype: str = "float32", *,
                        generator=None) -> flows.FlowModel:
    """num_layers x [ActNorm, InvertibleLinear, MixtureCDFCoupling(RGCN,
    2 layers), SoftClamp], parities alternating; scanned (``ScannedBlocks``
    of two-parity blocks) at an even depth of at least 4, as the
    reference's."""
    out_dim = dim * (2 + 3 * num_mixtures)
    return flows.coupling_stack(
        lambda: RGCN(dim, out_dim, hidden_dim=hidden_dim, num_layers=2,
                     compute_dtype=compute_dtype, generator=generator),
        dim, num_layers, num_mixtures, generator=generator)


@dataclasses.dataclass
class GraphColoringTask(TaskTemplate):
    min_nodes: int = 10
    max_nodes: int = 20
    num_colors: int = 3
    edge_prob: float = 0.25
    batch_size: int = 256
    encoding_dim: int = 2
    num_layers: int = 6
    hidden_dim: int = 96
    num_mixtures: int = 8
    eval_batches_count: int = 8
    metric_samples: int = 1024
    compute_dtype: str = "float32"
    seed: int = 0
    device: Optional[str] = None
    name: str = "graph_coloring"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.init_params(self.seed)

    def build_model(self, generator):
        enc = MixtureEncoding(self.num_colors, self.encoding_dim,
                              generator=generator)
        flow = build_coloring_flow(enc.dim, self.num_layers, self.hidden_dim,
                                   self.num_mixtures, self.compute_dtype,
                                   generator=generator)
        return CategoricalFlow(enc, flow)

    def _gen(self, rng: np.random.Generator, n: int) -> dict:
        N = self.max_nodes
        adj = np.zeros((n, N, N), np.float32)
        x = np.zeros((n, N), np.int32)
        mask = np.zeros((n, N), np.float32)
        for b in range(n):
            k = int(rng.integers(self.min_nodes, self.max_nodes + 1))
            a, c = random_colorable_graph(rng, k, self.num_colors,
                                          self.edge_prob)
            adj[b, :k, :k] = a
            x[b, :k] = c
            mask[b, :k] = 1.0
        return {"x": x, "mask": mask, "cond": {"adj": adj}}

    def train_batches(self, rng: np.random.Generator) -> Iterator[dict]:
        while True:
            yield self._gen(rng, self.batch_size)

    def eval_batches(self) -> list[dict]:
        rng = np.random.default_rng(7)
        return [self._gen(rng, self.batch_size)
                for _ in range(self.eval_batches_count)]

    @torch.no_grad()
    def sample_graphs(self, batch: dict, temperature: float = 1.0,
                      generator=None):
        """Colorings of the graphs of ``batch`` (numpy, as ``_gen`` makes
        them): a prior draw from ``generator``, the flow's inverse given the
        adjacency, the Bayes decode.  Returns (colors [n, N] int numpy, the
        posterior p(x|z) [n, N, C] numpy)."""
        mask = self._tensor(batch["mask"])
        z = self.model.flow.sample(
            (len(batch["x"]), self.max_nodes, self.model.encoding.dim),
            cond=self._tensor(batch["cond"]), mask=mask,
            temperature=float(temperature), generator=generator,
            device=self.device)
        enc = self.model.encoding
        return (enc.decode(z, mask=mask).cpu().numpy(),
                enc.posterior(z).cpu().numpy())

    def sample_metrics(self, generator=None, num_samples: int | None = None,
                       temperature: float = 1.0, best_of_k: int = 1) -> dict:
        """Validity of sampled colorings of fresh graphs (a numpy generator
        seeded 123, full batches of ``batch_size``; noise from
        ``generator``), the reference's columns: the raw argmax decode
        (``coloring_validity``, the headline); the same samples after
        ``repair_coloring`` (``coloring_validity_corrected``); with
        ``best_of_k > 1``, whether any of ``best_of_k`` independent samples
        of a graph is valid (``coloring_validity_at_k``).  Each with its
        95% interval."""
        num_samples = num_samples or self.metric_samples
        np_rng = np.random.default_rng(123)
        valids, valids_corr, valids_at_k = [], [], []
        done = 0
        while done < num_samples:
            b = min(self.batch_size, num_samples - done)
            batch = self._gen(np_rng, self.batch_size)
            adj, mask = batch["cond"]["adj"], batch["mask"]
            x, post = self.sample_graphs(batch, temperature, generator)
            valid = coloring_validity(adj, x, mask)
            fixed = repair_coloring(adj, post, x, mask)
            valids.append(valid[:b])
            valids_corr.append(coloring_validity(adj, fixed, mask)[:b])
            if best_of_k > 1:
                any_valid = valid.copy()
                for _ in range(1, best_of_k):
                    xj, _ = self.sample_graphs(batch, temperature, generator)
                    any_valid |= coloring_validity(adj, xj, mask)
                valids_at_k.append(any_valid[:b])
            done += b

        def rate(chunks):
            v = np.concatenate(chunks)
            p = float(v.mean())
            return p, float(1.96 * np.sqrt(max(p * (1 - p), 0.0) / len(v)))

        p, ci = rate(valids)
        pc, cic = rate(valids_corr)
        out = {"coloring_validity": p, "coloring_validity_ci95": ci,
               "coloring_validity_corrected": pc,
               "coloring_validity_corrected_ci95": cic,
               "metric_num_samples": float(done)}
        if best_of_k > 1:
            pk, cik = rate(valids_at_k)
            out.update(coloring_validity_at_k=pk,
                       coloring_validity_at_k_ci95=cik,
                       best_of_k=float(best_of_k))
        return out
