"""SMILES -> molecular-graph conversion, pure Python (no RDKit).

The port's own copy of ``categoricalnf_tpu/data/smiles.py``, the same
strings in and out:

  - organic-subset atoms (B C N O P S F Cl Br I) and bracket atoms with
    charges / explicit H counts / atom classes;
  - single/double/triple bonds, branches, ring closures (including %nn);
  - aromatic rings (lowercase atoms / ``:`` bonds) with **kekulization**
    via a backtracking perfect matching on the aromatic subgraph;
  - stereo markers (``/ \\ @ @@``) are parsed and dropped.

Formal charges budget valence during kekulization; the emitted atom
vocabulary is the 9 heavy-atom types of ``tasks/chem.py``.  Molecules that
fail to parse or kekulize return ``None``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from categoricalnf_tpu_torch.tasks.chem import ATOM_TYPES

# Two-character elements must match before single characters.
_ORGANIC = ["Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I",
            "b", "c", "n", "o", "p", "s"]
_BRACKET_RE = re.compile(
    r"\[(?P<isotope>\d+)?(?P<element>[A-Z][a-z]?|[bcnops]|se|as)"
    r"(?P<chiral>@{1,2})?(?P<hcount>H\d*)?(?P<charge>[+-]\d*|[+]+|[-]+)?"
    r"(?::(?P<cls>\d+))?\]")

_BOND_ORDER = {"-": 1, "=": 2, "#": 3, ":": "ar", "/": 1, "\\": 1}

# Default (neutral) valences used for aromatic bookkeeping and implicit-H
# assignment; effective valence = base + formal charge (N+ -> 4, O- -> 1).
_VALENCE = {"B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2,
            "F": 1, "Cl": 1, "Br": 1, "I": 1}


@dataclasses.dataclass
class _Atom:
    element: str            # canonical capitalisation ("C", "Cl", ...)
    aromatic: bool = False
    charge: int = 0
    h_count: Optional[int] = None   # None = implicit


class SmilesError(ValueError):
    pass


def _tokenize_atom(s: str, i: int):
    """Parse one atom starting at s[i]; returns (_Atom, next_index)."""
    if s[i] == "[":
        m = _BRACKET_RE.match(s, i)
        if m is None:
            raise SmilesError(f"bad bracket atom at {i}: {s[i:i+10]!r}")
        elem = m.group("element")
        aromatic = elem[0].islower()
        elem = elem.capitalize()
        h = m.group("hcount")
        h_count = 0 if h is None else (1 if h == "H" else int(h[1:]))
        c = m.group("charge") or ""
        if c in ("", None):
            charge = 0
        elif set(c) <= {"+"}:
            charge = len(c)
        elif set(c) <= {"-"}:
            charge = -len(c)
        else:
            charge = int(c)
        return _Atom(elem, aromatic, charge, h_count), m.end()
    for tok in _ORGANIC:
        if s.startswith(tok, i):
            return (_Atom(tok.capitalize(), tok[0].islower()),
                    i + len(tok))
    raise SmilesError(f"unknown atom at {i}: {s[i:i+4]!r}")


def parse_smiles(s: str) -> tuple[list[_Atom], list[tuple[int, int, object]]]:
    """Parse SMILES into (atoms, bonds); bond order is 1/2/3 or 'ar'."""
    atoms: list[_Atom] = []
    bonds: list[tuple[int, int, object]] = []
    prev: Optional[int] = None
    pending = None                       # bond symbol before next atom
    stack: list[int] = []
    rings: dict[str, tuple[int, object]] = {}
    i, n = 0, len(s)

    def add_bond(a: int, b: int, order):
        if order is None:
            order = "ar" if (atoms[a].aromatic and atoms[b].aromatic) else 1
        bonds.append((a, b, order))

    while i < n:
        ch = s[i]
        if ch in _BOND_ORDER:
            pending = _BOND_ORDER[ch]
            i += 1
        elif ch == "(":
            if prev is None:
                raise SmilesError("branch with no prior atom")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError("unmatched ')'")
            prev = stack.pop()
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                label, i = s[i + 1:i + 3], i + 3
            else:
                label, i = ch, i + 1
            if prev is None:
                raise SmilesError("ring closure with no prior atom")
            if label in rings:
                a, open_bond = rings.pop(label)
                order = pending if pending is not None else open_bond
                add_bond(a, prev, order)
            else:
                rings[label] = (prev, pending)
            pending = None
        elif ch == ".":
            # disconnected component separator: keep parsing; the valency
            # checker downstream rejects fragments, preprocessing can keep
            # the largest component if desired.
            prev, pending = None, None
            i += 1
        else:
            atom, i = _tokenize_atom(s, i)
            atoms.append(atom)
            idx = len(atoms) - 1
            if prev is not None:
                add_bond(prev, idx, pending)
            prev, pending = idx, None
    if rings:
        raise SmilesError(f"unclosed ring labels {sorted(rings)}")
    if stack:
        raise SmilesError("unclosed branch")
    return atoms, bonds


def _kekulize(atoms: list[_Atom],
              bonds: list[tuple[int, int, object]]
              ) -> Optional[list[tuple[int, int, int]]]:
    """Assign integer orders to aromatic bonds via perfect matching.

    Each aromatic atom with spare effective valence after its sigma bonds
    must take exactly ONE double bond within the aromatic system
    (pyrrole-type N / aromatic O,S contribute a lone pair instead and take
    none).  Returns integer-order bonds, or None if no valid assignment
    exists.
    """
    degree = [0] * len(atoms)
    for a, b, _ in bonds:
        degree[a] += 1
        degree[b] += 1

    def sigma(idx: int) -> int:
        at = atoms[idx]
        if at.h_count is not None:
            return degree[idx] + at.h_count
        if not at.aromatic:
            return degree[idx]
        # implicit H on non-bracket aromatic atoms: aromatic C fills to 3
        # sigma connections; aromatic N/O/S/P get none.
        if at.element == "C":
            return max(degree[idx], 3)
        return degree[idx]

    needs = {}
    for idx, at in enumerate(atoms):
        if not at.aromatic:
            continue
        v_eff = _VALENCE.get(at.element, 4) + at.charge
        needs[idx] = (v_eff - sigma(idx)) >= 1

    ar_edges = [(a, b) for a, b, o in bonds if o == "ar"]
    cand = {i: [] for i in needs if needs[i]}
    for a, b in ar_edges:
        if needs.get(a) and needs.get(b):
            cand[a].append(b)
            cand[b].append(a)

    matched: dict[int, int] = {}

    def backtrack() -> bool:
        todo = [i for i in cand if i not in matched]
        if not todo:
            return True
        # most-constrained atom first
        i = min(todo, key=lambda t: sum(1 for j in cand[t]
                                        if j not in matched))
        for j in cand[i]:
            if j in matched:
                continue
            matched[i] = j
            matched[j] = i
            if backtrack():
                return True
            del matched[i], matched[j]
        return False

    if not backtrack():
        return None

    out = []
    for a, b, o in bonds:
        if o == "ar":
            o = 2 if matched.get(a) == b else 1
        out.append((a, b, int(o)))
    return out


_ORDER_SYM = {1: "", 2: "=", 3: "#"}


def graph_to_smiles(atoms: np.ndarray, adj: np.ndarray) -> str:
    """Molecular graph -> kekulized SMILES string.

    Inverse of :func:`smiles_to_graph` up to graph isomorphism (bond
    orders are written explicitly — ``=``/``#`` — never as aromatic
    lowercase, so the output needs no kekulization to re-parse).  Used to
    report sampled molecules as SMILES (reference parity: RDKit
    ``MolToSmiles`` on generated graphs, SURVEY.md C26) and to emit
    ``.smi`` corpora that exercise the full ingestion path end-to-end.
    Disconnected components are joined with ``.``.
    """
    n = len(atoms)
    neigh = [list(np.nonzero(adj[i])[0]) for i in range(n)]
    visited = [False] * n
    # Pass 1: DFS forest — tree children + ring-closure (back) edges.
    children: list[list[int]] = [[] for _ in range(n)]
    ring_digits: dict[int, list[tuple[str, int]]] = {}   # atom -> labels
    next_digit = [1]
    roots = []
    for root in range(n):
        if visited[root]:
            continue
        roots.append(root)
        stack = [root]
        visited[root] = True
        while stack:
            i = stack.pop()
            for j in neigh[i]:
                if not visited[j]:
                    visited[j] = True
                    children[i].append(j)
                    stack.append(j)
    # back edges = graph edges minus tree edges (count each once)
    tree = {(min(i, j), max(i, j)) for i in range(n) for j in children[i]}
    sym_at: dict[tuple[int, int], str] = {}
    for i in range(n):
        for j in neigh[i]:
            if i < j and (i, j) not in tree:
                d = next_digit[0]
                next_digit[0] += 1
                lbl = str(d) if d < 10 else f"%{d:02d}"
                sym = _ORDER_SYM[int(adj[i, j])]
                ring_digits.setdefault(i, []).append((sym + lbl, d))
                ring_digits.setdefault(j, []).append((lbl, d))

    def emit(i: int, parent: int) -> str:
        s = ATOM_TYPES[int(atoms[i])]
        if parent >= 0:
            s = _ORDER_SYM[int(adj[parent, i])] + s
        s += "".join(lbl for lbl, _ in ring_digits.get(i, ()))
        kids = children[i]
        parts = [emit(j, i) for j in kids]
        return s + "".join(f"({p})" for p in parts[:-1]) + (
            parts[-1] if parts else "")

    return ".".join(emit(r, -1) for r in roots)


def smiles_to_graph(s: str) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """SMILES -> (atom-type ids [n], dense bond-order matrix [n, n]).

    Returns None for SMILES that fail to parse, contain elements outside
    the 9-type Zinc vocabulary, or cannot be kekulized.
    """
    try:
        atoms, bonds = parse_smiles(s.strip())
    except SmilesError:
        return None
    if not atoms:
        return None
    type_idx = {t: i for i, t in enumerate(ATOM_TYPES)}
    ids = []
    for at in atoms:
        if at.element not in type_idx:
            return None          # e.g. explicit H, Si, Se — out of vocab
        ids.append(type_idx[at.element])
    kek = _kekulize(atoms, bonds)
    if kek is None:
        return None
    n = len(atoms)
    adj = np.zeros((n, n), np.int64)
    for a, b, o in kek:
        if a == b or adj[a, b] != 0:
            return None
        adj[a, b] = adj[b, a] = o
    return np.asarray(ids, np.int32), adj
