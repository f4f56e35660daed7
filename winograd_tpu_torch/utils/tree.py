"""Parameter trees: nested dicts and lists of tensors, None for an absent
part (a stage without a transition). The port's stand-in for jax.tree's
leaves and map, which the training step (models/train.py) and the
rematerializing backward (kernels/vjp.py) need. Leaves are visited in the
dicts' insertion order, the same in both functions."""

from __future__ import annotations

from typing import Callable, List


def tree_leaves(tree) -> List:
    """The leaves of `tree`, depth first."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """`tree` with each leaf replaced by fn(leaf, *the same leaf of each tree
    in rest); the trees share one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(like, leaves: List):
    """The tree of `like`'s structure whose leaves are `leaves`, in
    tree_leaves' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
