"""Parameter trees of the port: flat ``{dotted name: tensor}`` dicts.

The reference keeps params as nested dicts and walks them with
``jax.tree_util``, which visits dict keys sorted at every level — so its
first ResNet-20 leaf is ``gn0/bias`` and its last is ``stem``.  The port
keeps one flat dict whose names are the reference's key paths joined by
dots (``"s0b0.gn1.scale"``, the names ``nn.Module.named_parameters`` and
``torch.func.functional_call`` use) and orders leaves by the tuple of path
components, which is the reference's order.  Every layout decision that
depends on leaf order (``KernelPlan`` rows) goes through :func:`leaf_order`.
"""
from __future__ import annotations

__all__ = ["leaf_order", "tree_leaves", "tree_map"]


def leaf_order(names) -> list:
    """Names sorted as ``jax.tree_util`` orders the nested-dict leaves."""
    return sorted(names, key=lambda n: n.split("."))


def tree_leaves(tree) -> list:
    """Leaves of a flat dict in reference order; a bare tensor is one leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in leaf_order(tree)]
    return [tree]


def tree_map(f, *trees):
    """``f`` over matching leaves of flat dicts (or over bare tensors)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: f(*(t[k] for t in trees)) for k in first}
    return f(*trees)
