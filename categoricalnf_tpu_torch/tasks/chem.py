"""Pure-python chemistry: valency rules, validity, correction, graph hashes.

The port's own copy of ``categoricalnf_tpu/tasks/chem.py`` (numpy only, the
same functions and the same draws from a ``np.random.Generator``, bit for
bit).  RDKit is not used: per-element maximum valence, bond-order
accounting, connectivity, and a Weisfeiler-Lehman graph hash for
uniqueness and novelty.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

# Heavy atoms used by Zinc250k, in a fixed order.
ATOM_TYPES = ["C", "N", "O", "F", "P", "S", "Cl", "Br", "I"]
MAX_VALENCE = {"C": 4, "N": 3, "O": 2, "F": 1, "P": 5, "S": 6,
               "Cl": 1, "Br": 1, "I": 1}
MAX_VALENCE_ARR = np.asarray([MAX_VALENCE[a] for a in ATOM_TYPES])


def edges_to_dense(edges: np.ndarray, n: int) -> np.ndarray:
    """[E] upper-tri bond orders -> dense symmetric [n, n] matrix."""
    iu = np.triu_indices(n, k=1)
    out = np.zeros((n, n), edges.dtype)
    out[iu] = edges
    return out + out.T


def dense_to_edges(adj: np.ndarray) -> np.ndarray:
    iu = np.triu_indices(adj.shape[0], k=1)
    return adj[iu]


def molecule_validity(atoms: np.ndarray, edges: np.ndarray,
                      node_mask: np.ndarray,
                      check_connected: bool = True) -> np.ndarray:
    """Per-molecule validity for a batch.

    atoms [B,N] atom-type ids; edges [B,E] bond orders (0=no bond);
    node_mask [B,N] (any boolean pattern, not necessarily a prefix).

    Two definitions, both reported by the molecule task:

    - ``check_connected=False`` — **reference-comparable**: valid iff every
      atom's total bond order is within its max valence.  This matches the
      RDKit ``MolFromSmiles``-sanitization criterion the reference (and the
      molecule-generation literature) uses: a disconnected graph parses as
      dot-separated fragment SMILES and an isolated neutral atom is a valid
      one-atom molecule (implicit hydrogens), so neither fails sanitization.
    - ``check_connected=True`` — **strict**: additionally require every
      atom to have >= 1 bond and the heavy-atom graph to be connected
      (a single molecule, no fragments).
    """
    B, N = atoms.shape
    out = np.zeros(B, bool)
    for b in range(B):
        idx = np.nonzero(node_mask[b] > 0)[0]
        k = len(idx)
        if k == 0:
            continue
        adj = edges_to_dense(edges[b], N)[np.ix_(idx, idx)]
        a = atoms[b, idx]
        val = adj.sum(axis=1)
        if np.any(val > MAX_VALENCE_ARR[a]):
            continue
        if check_connected and k > 1 and (
                np.any(val == 0) or not _connected(adj)):
            continue
        out[b] = True
    return out


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i] > 0)[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


def valency_correction(atoms: np.ndarray, edges: np.ndarray,
                       node_mask: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Reference-style post-processing: fix valence violations, then keep
    the largest connected component.

    Returns (corrected edges [B, E], corrected node_mask [B, N]) — atoms
    outside the surviving component are removed from the molecule, exactly
    as the reference's RDKit-based correction yields a smaller molecule.
    """
    B, N = atoms.shape
    out = edges.copy()
    new_mask = node_mask.copy().astype(np.float32)
    for b in range(B):
        k = int(node_mask[b].sum())
        if k == 0:
            continue
        adj = edges_to_dense(out[b], N).astype(np.int64)
        a = atoms[b, :k]
        maxv = MAX_VALENCE_ARR[a]
        # 1) downgrade bonds on violating atoms (highest order first)
        for i in range(k):
            while adj[i, :k].sum() > maxv[i]:
                j = int(np.argmax(adj[i, :k]))
                adj[i, j] -= 1
                adj[j, i] -= 1
        # 2) keep largest connected component, dropping the rest
        comp = _components(adj[:k, :k])
        sizes = np.bincount(comp)
        keep = comp == np.argmax(sizes)
        drop = ~keep
        adj[np.ix_(np.arange(k)[drop], np.arange(k))] = 0
        adj[np.ix_(np.arange(k), np.arange(k)[drop])] = 0
        new_mask[b, :k] = keep.astype(np.float32)
        out[b] = dense_to_edges(adj.astype(edges.dtype))
    return out, new_mask


def _components(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    comp = -np.ones(n, np.int64)
    c = 0
    for s in range(n):
        if comp[s] >= 0:
            continue
        comp[s] = c
        stack = [s]
        while stack:
            i = stack.pop()
            for j in np.nonzero(adj[i] > 0)[0]:
                if comp[j] < 0:
                    comp[j] = c
                    stack.append(int(j))
        c += 1
    return comp


def wl_hash(atoms: np.ndarray, edges: np.ndarray, node_mask: np.ndarray,
            iters: int = 3) -> str:
    """Weisfeiler-Lehman hash of one molecule — canonical up to WL
    indistinguishability; used for uniqueness/novelty counting."""
    idx = np.nonzero(np.asarray(node_mask) > 0)[0]
    k = len(idx)
    if k == 0:
        return "empty"
    N = atoms.shape[0]
    adj = edges_to_dense(edges, N)[np.ix_(idx, idx)]
    labels = [f"a{t}" for t in atoms[idx]]
    for _ in range(iters):
        new = []
        for i in range(k):
            neigh = sorted(f"{adj[i, j]}:{labels[j]}"
                           for j in np.nonzero(adj[i] > 0)[0])
            new.append(hashlib.sha1(
                (labels[i] + "|" + ",".join(neigh)).encode()).hexdigest()[:12])
        labels = new
    canon = ",".join(sorted(labels))
    return hashlib.sha1(canon.encode()).hexdigest()


def sample_quality(atoms: np.ndarray, edges: np.ndarray,
                   node_mask: np.ndarray,
                   train_hashes: Optional[set] = None,
                   correct: bool = False,
                   check_connected: bool = True) -> dict:
    """validity / uniqueness / novelty for a batch of sampled molecules.

    ``check_connected`` selects between the strict and the
    reference-comparable validity definition (see ``molecule_validity``);
    uniqueness/novelty are computed over the molecules valid under the
    chosen definition, as the reference does over its RDKit-valid set.
    """
    if correct:
        edges, node_mask = valency_correction(atoms, edges, node_mask)
    valid = molecule_validity(atoms, edges, node_mask,
                              check_connected=check_connected)
    hashes = [wl_hash(atoms[b], edges[b], node_mask[b])
              for b in range(atoms.shape[0]) if valid[b]]
    n_valid = len(hashes)
    uniq = len(set(hashes))
    out = {"validity": float(valid.mean()),
           "uniqueness": uniq / n_valid if n_valid else 0.0}
    if train_hashes is not None:
        novel = sum(1 for h in set(hashes) if h not in train_hashes)
        out["novelty"] = novel / uniq if uniq else 0.0
    return out


def zinc_like_molecule(rng: np.random.Generator, target_atoms: int,
                       leaf_style: str = "zinc"
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Generate a STRUCTURED valid molecule graph (drug-like motifs).

    Zero-egress stand-in for real Zinc250k with realistic local structure,
    unlike ``random_molecule`` whose uniform tree+ring graphs are near
    max-entropy given valence (a distribution no model can sample validly
    with high probability — measured raw validity plateaued <10%).  Motif
    grammar: benzene-like 6-rings with alternating double bonds (kekulized
    aromatics), saturated 5/6-rings with at most one heteroatom, short
    carbon chains; units joined by single bonds; decorations are carbonyl
    =O, halogens, OH/NH2-like heteroatom leaves.  Reference parity: plays
    the role of Zinc250k's empirical distribution (SURVEY.md C26).

    Returns (atoms [n], dense adj [n, n]) with n <= target_atoms; always
    valid under ``molecule_validity`` by construction.

    ``leaf_style`` selects the halogen/heteroatom decoration mix:
    ``"zinc"`` (default — F/Cl/O/N) or ``"moses"`` (adds Br, the visible
    compositional difference of the Moses benchmark's Clean-Leads subset;
    SURVEY.md §6 Moses row).
    """
    C, N, O, F, _, S, Cl, Br, _I = range(9)
    if leaf_style == "moses":
        halogen_leaves, halogen_p = [F, Cl, Br, O, N], [0.25, 0.15, 0.10,
                                                        0.30, 0.20]
    else:
        halogen_leaves, halogen_p = [F, Cl, O, N], [0.3, 0.2, 0.3, 0.2]
    atoms: list[int] = []
    bonds: list[tuple[int, int, int]] = []

    def add(t: int) -> int:
        atoms.append(t)
        return len(atoms) - 1

    def used(i: int) -> int:
        return sum(o for a, b, o in bonds if i in (a, b))

    def spare(i: int) -> int:
        return int(MAX_VALENCE_ARR[atoms[i]]) - used(i)

    def new_unit(room: int) -> list[int]:
        """Append one motif; returns its atom ids (bonds added in place)."""
        kind = rng.choice(["arom6", "sat_ring", "chain"],
                          p=[0.40, 0.25, 0.35])
        if kind == "arom6" and room >= 6:
            ids = [add(C) for _ in range(6)]
            # pyridine-like N substitution (ring valence 3 = N's max)
            if rng.random() < 0.35:
                atoms[ids[int(rng.integers(6))]] = N
            for k in range(6):
                bonds.append((ids[k], ids[(k + 1) % 6], 2 - (k % 2)))
            return ids
        if kind == "sat_ring" and room >= 5:
            sz = 5 if rng.random() < 0.5 else min(6, room)
            ids = [add(C) for _ in range(sz)]
            if rng.random() < 0.5:    # THF / pyrrolidine / thiolane-like
                atoms[ids[int(rng.integers(sz))]] = int(
                    rng.choice([N, O, S], p=[0.45, 0.45, 0.10]))
            for k in range(sz):
                bonds.append((ids[k], ids[(k + 1) % sz], 1))
            return ids
        sz = int(rng.integers(1, min(4, room) + 1))
        ids = [add(int(rng.choice([C, N, O], p=[0.70, 0.15, 0.15])))
               for _ in range(sz)]
        for k in range(sz - 1):
            bonds.append((ids[k], ids[k + 1], 1))
        return ids

    unit = new_unit(target_atoms)
    while len(atoms) < target_atoms - 1:
        hooks = [i for i in range(len(atoms)) if spare(i) >= 1]
        if not hooks:
            break
        room = target_atoms - len(atoms)
        if room < 1:
            break
        a = int(rng.choice(hooks))
        unit = new_unit(room)
        ports = [i for i in unit if spare(i) >= 1]
        if not ports:     # unreachable (every motif keeps >=1 open port);
            del atoms[min(unit):]      # roll the unit back rather than
            bonds = [e for e in bonds  # ever keep a disconnected fragment
                     if e[0] < len(atoms) and e[1] < len(atoms)]
            break
        b = int(rng.choice(ports))
        bonds.append((a, b, 1))
    # decorations: carbonyl =O on sp3 carbons, halogen/OH/NH2 leaves
    for i in list(range(len(atoms))):
        if len(atoms) >= target_atoms:
            break
        if atoms[i] == C and spare(i) >= 2 and rng.random() < 0.15:
            bonds.append((i, add(O), 2))
        elif spare(i) >= 1 and rng.random() < 0.10:
            leaf = int(rng.choice(halogen_leaves, p=halogen_p))
            bonds.append((i, add(leaf), 1))
    n = len(atoms)
    adj = np.zeros((n, n), np.int64)
    for a, b, o in bonds:
        adj[a, b] = adj[b, a] = o
    return np.asarray(atoms, np.int32), adj


def random_molecule(rng: np.random.Generator, num_atoms: int,
                    ring_prob: float = 0.3,
                    double_prob: float = 0.15) -> tuple[np.ndarray, np.ndarray]:
    """Generate a random VALID molecule graph (tree + rings, valence-safe).

    Used as the synthetic stand-in when Zinc250k/Moses files are absent
    (zero-egress environment).  Returns (atoms [n], dense adj [n, n]).
    """
    # bias toward organic-chemistry-ish composition
    probs = np.asarray([0.72, 0.10, 0.10, 0.02, 0.01, 0.03, 0.01, 0.005,
                        0.005])
    probs = probs / probs.sum()
    atoms = rng.choice(len(ATOM_TYPES), num_atoms, p=probs)
    maxv = MAX_VALENCE_ARR[atoms]
    adj = np.zeros((num_atoms, num_atoms), np.int64)

    def spare(i):
        return maxv[i] - adj[i].sum()

    # spanning tree
    for i in range(1, num_atoms):
        cands = [j for j in range(i) if spare(j) >= 1]
        if not cands:
            cands = [int(np.argmax(maxv[:i] - adj[:i, :].sum(1)))]
            # force carbon to have room: re-assign atom j to carbon
            j = cands[0]
            atoms[j] = 0
            maxv[j] = MAX_VALENCE_ARR[0]
        j = int(rng.choice(cands))
        order = 1
        if rng.random() < double_prob and spare(j) >= 2 and maxv[i] >= 2:
            order = 2
        adj[i, j] = adj[j, i] = order
    # extra ring bonds
    n_rings = rng.poisson(ring_prob * num_atoms / 10)
    for _ in range(n_rings):
        cand = [(i, j) for i in range(num_atoms) for j in range(i + 1,
                                                                num_atoms)
                if adj[i, j] == 0 and spare(i) >= 1 and spare(j) >= 1]
        if not cand:
            break
        i, j = cand[int(rng.integers(len(cand)))]
        adj[i, j] = adj[j, i] = 1
    return atoms.astype(np.int32), adj
