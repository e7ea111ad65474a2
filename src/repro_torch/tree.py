"""Nested dict / list trees of tensors (the port's stand-in for JAX's
pytrees of parameters, gradients and optimizer state)."""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over one tree, or over several trees of the
    same structure (``fn(leaf, *other_leaves)``).  Leaves are whatever is
    not a dict or a list (tensors, PackedTensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in a fixed order (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
