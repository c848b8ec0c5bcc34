"""Parameter and state trees: the port's stand-in for ``jax.tree``.

Parameters, optimizer moments and targets are dicts of dicts of tensors
(``{"l0": {"w": ..., "b": ...}, ...}``) or a bare tensor (``log_alpha``);
the trainer's carry and the checkpoint files add NamedTuples
(``AlgoState``, ``ReplayState``, ``OptState``), tuples and lists, and
``None`` is an empty subtree, as in JAX. Leaves are visited in insertion
order, so trees built from one another with ``tree_map`` line up leaf
for leaf. ``leaves_with_path`` names each leaf as JAX prints its key
path. ``stack_trees`` / ``unstack_tree`` stand in for ``vmap``-built and
scanned-over stacks of dict trees.
"""
from typing import Any, Callable, Iterator, List, Tuple

import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over every leaf of ``tree`` (and the matching leaves of
    ``rest``), the structure kept: NamedTuples rebuilt by field, ``None``
    left as it is."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if _is_namedtuple(tree) else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return [tree]
    return [leaf for v in tree for leaf in tree_leaves(v)]


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


def leaves_with_path(tree, prefix: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf of a tree of dicts, NamedTuples,
    tuples and lists, in order: a dict key as ``str(key)``, a NamedTuple
    field as ``.<field>`` and a sequence index as ``str(i)``, as JAX
    prints its key paths. ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif _is_namedtuple(tree):
        items = (("." + k, v) for k, v in zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from leaves_with_path(v, prefix + (k,))
