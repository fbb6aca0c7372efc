"""A tree map over nested dicts, lists and tuples (the port's counterpart of
``jax.tree.map`` for batches, whose ``cond`` may be a dict of arrays)."""

from __future__ import annotations


def tree_map(fn, tree):
    """``fn`` applied to every leaf of ``tree``; dicts, lists and tuples keep
    their structure and ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
