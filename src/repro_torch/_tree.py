"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Parameters, optimizer moments and targets are dicts of dicts of tensors
(``{"l0": {"w": ..., "b": ...}, ...}``) or a bare tensor (``log_alpha``).
Leaves are visited in insertion order, so trees built from one another
with ``tree_map`` line up leaf for leaf.
"""
from typing import Callable, List

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
