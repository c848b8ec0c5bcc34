"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Parameters, optimizer moments and targets are dicts of dicts of tensors
(``{"l0": {"w": ..., "b": ...}, ...}``) or a bare tensor (``log_alpha``).
Leaves are visited in insertion order, so trees built from one another
with ``tree_map`` line up leaf for leaf. ``stack_trees`` /
``unstack_tree`` stand in for ``vmap``-built and scanned-over stacks.
"""
from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stack_trees(trees: List[Any]) -> Any:
    """A list of equally shaped trees -> one tree of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def unstack_tree(tree: Any, n: int) -> List[Any]:
    """A tree of (n, ...) leaves -> n trees of views, one per layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack_tree(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))
