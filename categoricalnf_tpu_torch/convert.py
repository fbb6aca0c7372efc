"""Carry weights of the JAX package across to the port.

``from_jax_params(task, params)`` takes the reference's parameter tree
``{"encoding": {...}, "flow": (per-layer dicts, ...)}`` with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side) and returns a
``state_dict`` for ``task.model``.  The port names its parameters as the
reference's tree does, so a nested key path becomes a dotted name; dense
weights stay ``[in, out]``.  A ``ScannedBlocks`` entry of the reference's
flow is a tuple of per-layer trees whose leaves carry a leading depth axis;
the port holds one block of modules for each depth
(``flow.layers.<i>.blocks.<d>.<layer>.<name>``), so the leaves are split
along that axis.  An encoding's own flow (the dequantization and
linear-flows encodings: ``{"embed", "flow", ...}``) is a tuple of per-layer
trees as well, held as ``encoding.flow.layers.<i>``; a learned decoder's
tree is ``encoding.decoder``.  A parametric prior's tree (the HMM prior's
``start_logits``, ``trans_logits``, ``means``, ``log_scales``) is the last
entry of the reference's flow tuple and the port's ``flow.prior``.  The
LSTM's cells and head keep the reference's names (``net.cells.<i>.wx.w``,
``net.out.b``), the causal transformer's too (``net.embed.w``, ``net.pos``,
``net.blocks.<i>.qkv.w``, ``proj``, ``fc1``, ``fc2``, ``net.out.b``), and
the autoregressive layers' ``mean_offsets`` and ``feat`` theirs.  GraphCNF's tree (``enc_node``, ``enc_exist``,
``enc_bond``, ``flow_node``, ``flow_exist``, ``flow_bond``) keeps its names,
each flow split as above; the EdgeGNN blocks keep the reference's names
(``net.blocks.<i>.v2e.w``).  Imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from categoricalnf_tpu_torch.utils.tree import tree_map


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


def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _split_depth(entry) -> dict:
    """A scanned entry (a tuple of per-layer trees stacked along depth) as
    the port's ``{"blocks": [[layer tree, ...] for each depth]}``."""
    leaves = _leaves(entry)
    if not leaves:
        raise ValueError("a scanned stack without parameters has no depth")
    depth = np.shape(leaves[0])[0]
    return {"blocks": [tree_map(lambda a: np.asarray(a)[d], list(entry))
                       for d in range(depth)]}


def _flow_tree(flow, prefix: str, parametric_prior: bool) -> dict:
    """A reference flow's tuple of per-layer trees (scanned entries split
    along depth; a parametric prior's tree last) as flat names under
    ``prefix``."""
    flow = list(flow)
    prior = flow.pop() if parametric_prior else {}
    flow = [_split_depth(e) if isinstance(e, (list, tuple)) else e
            for e in flow]
    return {**flatten_tree(flow, f"{prefix}.layers."),
            **flatten_tree(prior, f"{prefix}.prior.")}


# GraphCNF's tree: three encodings and three flows, named as the port's
_GRAPHCNF_ENCODINGS = ("enc_node", "enc_exist", "enc_bond")
_GRAPHCNF_FLOWS = ("flow_node", "flow_exist", "flow_bond")


def from_jax_params(task, params) -> dict:
    """A ``state_dict`` for ``task.model`` from the reference's params."""
    if "flow_node" in params:
        flat = {}
        for name in _GRAPHCNF_ENCODINGS:
            flat.update(flatten_tree(params[name], f"{name}."))
        for name in _GRAPHCNF_FLOWS:
            flat.update(_flow_tree(params[name], name, False))
    else:
        enc = dict(params["encoding"])
        enc_flow = enc.pop("flow", ())
        flat = {**flatten_tree(enc, "encoding."),
                **flatten_tree(list(enc_flow), "encoding.flow.layers."),
                **_flow_tree(params["flow"], "flow", isinstance(
                    task.model.flow.prior, torch.nn.Module))}
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
