"""Molecule generation: GraphCNF on graphs of heavy atoms and bonds
(counterpart of ``categoricalnf_tpu/tasks/molecules.py``).

The dataset is a preprocessed ``{name}.npz`` in ``data_dir`` (arrays
``atoms`` [M, N] atom-type ids, ``edges`` [M, E] upper-triangular bond
orders, ``num_atoms`` [M]); ``dataset="synthetic"`` makes random valid
molecules in memory instead (``chem.random_molecule``), the reference's
generator bit for bit.  A named dataset whose file is missing raises.  The
likelihood adds a categorical prior over the node count; sample quality is
validity (raw: valences only, as RDKit's sanitization; strict: one
connected molecule; corrected: after the valency correction), uniqueness
and novelty against the training split.  Batches are dicts of numpy arrays
``atoms``, ``edges`` and ``node_mask``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

from categoricalnf_tpu_torch.models.graphcnf import LN2, GraphCNF
from categoricalnf_tpu_torch.tasks import chem
from categoricalnf_tpu_torch.training.task import TaskTemplate
from categoricalnf_tpu_torch.utils.device import resolve_device


def load_molecule_dataset(name: str, data_dir: Optional[str],
                          max_nodes: int, synth_size: int = 4096,
                          seed: int = 0) -> dict:
    data_dir = data_dir or os.environ.get("CNF_DATA_DIR", "data")
    path = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            atoms, edges = f["atoms"], f["edges"]
            num_atoms = f["num_atoms"]
    else:
        # only the explicit synthetic name falls back to the generator: a
        # run labelled with a named dataset must never train on another
        if name != "synthetic":
            raise FileNotFoundError(
                f"molecule dataset {name!r}: {path} not found — generate "
                "it with experiments/molecule_generation/preprocess.py "
                "or pass --dataset synthetic for the in-memory fallback")
        rng = np.random.default_rng(seed)
        E = max_nodes * (max_nodes - 1) // 2
        atoms = np.zeros((synth_size, max_nodes), np.int32)
        edges = np.zeros((synth_size, E), np.int32)
        num_atoms = rng.integers(8, max_nodes + 1, synth_size)
        for m in range(synth_size):
            n = int(num_atoms[m])
            a, adj = chem.random_molecule(rng, n)
            atoms[m, :n] = a
            full = np.zeros((max_nodes, max_nodes), np.int64)
            full[:n, :n] = adj
            edges[m] = chem.dense_to_edges(full)
    mask = (np.arange(max_nodes)[None, :]
            < num_atoms[:, None]).astype(np.float32)
    return {"atoms": atoms.astype(np.int32),
            "edges": edges.astype(np.int32),
            "node_mask": mask, "num_atoms": num_atoms.astype(np.int32)}


@dataclasses.dataclass
class MoleculeTask(TaskTemplate):
    dataset: str = "synthetic"
    data_dir: Optional[str] = None
    max_nodes: int = 24
    batch_size: int = 64
    num_layers_node: int = 4
    num_layers_edge: int = 4
    num_layers_bond: int = 0  # 0 = follow num_layers_edge
    hidden_dim: int = 96
    num_mixtures: int = 8
    edge_degree_norm: str = "nodes"
    bond_cond_exist: bool = False
    node_cond_atoms: bool = False
    bond_cond_degree: bool = False
    eval_batches_count: int = 8
    metric_samples: int = 1024
    synth_size: int = 2048
    compute_dtype: str = "float32"
    seed: int = 0
    device: Optional[str] = None
    name: str = "molecule_generation"

    # sample_eval may pass per-stage "t_node:t_exist:t_bond" temperatures
    supports_stage_temperatures = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.data = load_molecule_dataset(self.dataset, self.data_dir,
                                          self.max_nodes, self.synth_size)
        self.name = f"molecules_{self.dataset}"
        # the categorical prior over the node count (+1 smoothing)
        counts = np.bincount(self.data["num_atoms"],
                             minlength=self.max_nodes + 1).astype(np.float64)
        counts += 1.0
        self._logp_n = np.log(counts / counts.sum())
        self._split = int(0.9 * len(self.data["atoms"]))
        self._train_hashes = None  # built on first use, for novelty
        self.init_params(self.seed)

    def build_model(self, generator):
        return GraphCNF(
            num_atom_types=len(chem.ATOM_TYPES), num_bond_types=3,
            max_nodes=self.max_nodes, num_layers_node=self.num_layers_node,
            num_layers_edge=self.num_layers_edge,
            num_layers_bond=self.num_layers_bond, hidden_dim=self.hidden_dim,
            num_mixtures=self.num_mixtures,
            edge_degree_norm=self.edge_degree_norm,
            bond_cond_exist=self.bond_cond_exist,
            node_cond_atoms=self.node_cond_atoms,
            bond_cond_degree=self.bond_cond_degree,
            compute_dtype=self.compute_dtype, generator=generator)

    # -- data -----------------------------------------------------------------

    def _slice(self, idx) -> dict:
        return {"atoms": self.data["atoms"][idx],
                "edges": self.data["edges"][idx],
                "node_mask": self.data["node_mask"][idx]}

    def train_batches(self, rng: np.random.Generator) -> Iterator[dict]:
        while True:
            yield self._slice(rng.integers(0, self._split, self.batch_size))

    def eval_batches(self) -> list:
        rng = np.random.default_rng(5)
        return [self._slice(rng.integers(self._split,
                                         len(self.data["atoms"]),
                                         self.batch_size))
                for _ in range(self.eval_batches_count)]

    def _graph(self, batch):
        return (self._tensor(batch["atoms"], torch.long),
                self._tensor(batch["edges"], torch.long),
                self._tensor(batch["node_mask"], torch.float32))

    # -- objective ------------------------------------------------------------

    def loss(self, batch: dict, beta=1.0, *, generator=None, noise=None,
             batch_mean=None):
        return self.model.loss_bpd(*self._graph(batch), beta,
                                   generator=generator, noise=noise,
                                   batch_mean=batch_mean)

    @torch.no_grad()
    def eval_step(self, batch: dict, num_samples: int, *, generator=None,
                  noise=None) -> torch.Tensor:
        """Per-graph importance-sampled bpd (fp32 twin), the node-count
        prior included."""
        bpd = self.eval_model.eval_bpd(*self._graph(batch), num_samples,
                                       generator=generator, noise=noise)
        return bpd + self.eval_bpd_extra(batch)

    @torch.no_grad()
    def elbo(self, batch: dict, *, generator=None, noise=None):
        """Single-sample per-graph ELBO [B] (fp32 twin); ``noise``: the
        three stages' uniforms."""
        return self.eval_model.elbo(*self._graph(batch), generator=generator,
                                    noise=noise)["elbo"]

    def num_vars(self, batch) -> torch.Tensor:
        return self.model.num_vars(self._graph(batch)[2])

    def eval_bpd_extra(self, batch) -> torch.Tensor:
        """The node-count prior's share of the bits per variable."""
        node_mask = self._graph(batch)[2]
        logp_n = torch.as_tensor(self._logp_n, dtype=torch.float32,
                                 device=self.device)
        n = node_mask.sum(-1).long()
        return -logp_n[n] / (self.model.num_vars(node_mask) * LN2)

    @torch.no_grad()
    def data_init(self, batch: dict, *, generator=None, noise=None) -> None:
        self.model.data_init(*self._graph(batch), generator=generator,
                             noise=noise)

    # -- sampling and metrics -------------------------------------------------

    def sample_node_mask(self, rng: np.random.Generator,
                         batch: int) -> np.ndarray:
        p = np.exp(self._logp_n)
        counts = rng.choice(len(p), size=batch, p=p / p.sum())
        counts = np.maximum(counts, 1)
        return (np.arange(self.max_nodes)[None, :]
                < counts[:, None]).astype(np.float32)

    def _numpy_rng(self, generator) -> np.random.Generator:
        """The node counts' generator, seeded from ``generator``, so a
        request's graphs, like its noise, follow its generator."""
        dev = generator.device if generator is not None else self.device
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                 device=dev))
        return np.random.default_rng(seed)

    @torch.no_grad()
    def sample_many(self, num_samples: int, temperature=1.0, *,
                    generator=None):
        """(atoms, edges, node_mask) numpy, ``num_samples`` rows, sampled
        in full batches of ``batch_size`` (the node counts from the prior,
        the noise from ``generator``); ``temperature`` a scalar or
        (t_node, t_exist, t_bond)."""
        np_rng = self._numpy_rng(generator)
        out_a, out_e, out_m = [], [], []
        done = 0
        while done < num_samples:
            b = min(self.batch_size, num_samples - done)
            node_mask = self.sample_node_mask(np_rng, self.batch_size)
            atoms, edges = self.model.sample(self._tensor(node_mask),
                                             temperature,
                                             generator=generator)
            out_a.append(atoms[:b].cpu().numpy())
            out_e.append(edges[:b].cpu().numpy())
            out_m.append(node_mask[:b])
            done += b
        return (np.concatenate(out_a), np.concatenate(out_e),
                np.concatenate(out_m))

    def train_hashes(self) -> set:
        if self._train_hashes is None:
            d = self._slice(np.arange(self._split))
            self._train_hashes = {
                chem.wl_hash(d["atoms"][i], d["edges"][i], d["node_mask"][i])
                for i in range(len(d["atoms"]))}
        return self._train_hashes

    def sample_metrics(self, generator=None, num_samples: int | None = None,
                       temperature=1.0) -> dict:
        """The reference's columns: raw validity (valences only, fragments
        allowed, with its 95% interval), uniqueness and novelty over the
        valid molecules; strict validity (one connected molecule); the
        three after the valency correction."""
        num_samples = num_samples or self.metric_samples
        atoms, edges, node_mask = self.sample_many(num_samples, temperature,
                                                   generator=generator)
        hashes = self.train_hashes()
        raw = chem.sample_quality(atoms, edges, node_mask, hashes,
                                  correct=False, check_connected=False)
        strict = chem.sample_quality(atoms, edges, node_mask, hashes,
                                     correct=False, check_connected=True)
        fixed = chem.sample_quality(atoms, edges, node_mask, hashes,
                                    correct=True)
        n = float(len(atoms))
        p = raw["validity"]
        return {"validity": p,
                "validity_ci95": float(1.96 * np.sqrt(max(p * (1 - p), 0.0)
                                                      / n)),
                "uniqueness": raw["uniqueness"],
                "novelty": raw.get("novelty", 0.0),
                "validity_strict": strict["validity"],
                "validity_corrected": fixed["validity"],
                "uniqueness_corrected": fixed["uniqueness"],
                "novelty_corrected": fixed.get("novelty", 0.0),
                "metric_num_samples": n}

    def molecules_json(self, atoms, edges, node_mask) -> list:
        """Sampled graphs as the reference's JSON records: atom symbols,
        bonds [i, j, order], SMILES and raw validity."""
        # here, not at the top: smiles imports the tasks package's chem
        from categoricalnf_tpu_torch.data.smiles import graph_to_smiles
        valid = chem.molecule_validity(atoms, edges, node_mask,
                                       check_connected=False)
        out = []
        for b in range(len(atoms)):
            k = int(node_mask[b].sum())
            adj = chem.edges_to_dense(edges[b], self.max_nodes)[:k, :k]
            out.append({
                "atoms": [chem.ATOM_TYPES[a] for a in atoms[b, :k]],
                "bonds": [[int(i), int(j), int(adj[i, j])]
                          for i in range(k) for j in range(i + 1, k)
                          if adj[i, j] > 0],
                "smiles": graph_to_smiles(atoms[b, :k], adj),
                "valid": bool(valid[b])})
        return out

    @torch.no_grad()
    def sample_artifacts(self, out_dir: str, generator=None) -> None:
        """``sampled_molecules.json``: 32 molecules (node counts from a
        generator seeded 0) with their strict validity too."""
        node_mask = self.sample_node_mask(np.random.default_rng(0), 32)
        atoms, edges = self.model.sample(self._tensor(node_mask),
                                         generator=generator)
        atoms, edges = atoms.cpu().numpy(), edges.cpu().numpy()
        strict = chem.molecule_validity(atoms, edges, node_mask)
        out = self.molecules_json(atoms, edges, node_mask)
        for rec, s in zip(out, strict):
            rec["valid_strict"] = bool(s)
        with open(os.path.join(out_dir, "sampled_molecules.json"), "w") as f:
            json.dump(out, f, indent=1)
