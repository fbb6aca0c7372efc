"""Carry weights of the JAX package across to the port.

``from_jax_params(task, params)`` takes the reference's parameter tree
``{"encoding": {...}, "flow": (per-layer dicts, ...)}`` with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side) and returns a
``state_dict`` for ``task.model``.  The port names its parameters as the
reference's tree does, so a nested key path becomes a dotted name; dense
weights stay ``[in, out]``.  Imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts / lists of arrays -> ``{dotted.name: fp32 tensor}``."""
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = torch.from_numpy(
            np.array(tree, dtype=np.float32, copy=True))
    return out


def from_jax_params(task, params) -> dict:
    """A ``state_dict`` for ``task.model`` from the reference's params."""
    flat = {**flatten_tree(params["encoding"], "encoding."),
            **flatten_tree(list(params["flow"]), "flow.layers.")}
    want = task.model.state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for k, v in flat.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)}, want "
                             f"{tuple(want[k].shape)}")
    return flat
