"""Minimal pytree helpers over nested dicts / tuples / NamedTuples of
tensors (the counterpart of the ``jax.tree_util`` calls the JAX package
makes). Dict keys are visited in sorted order, as ``jax.tree_util`` does,
so leaf orders — and therefore global-norm sums — match the reference.
``None`` is an empty subtree. Leaf paths print as ``jax.tree_util.keystr``
does (``['key']`` for a dict key, ``[i]`` for a list or tuple index,
``.field`` for a NamedTuple field): checkpoints name their leaves by them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in ``tree_leaves`` order, each path as
    ``jax.tree_util.keystr`` prints it (e.g. ``['o'].b[0]``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pl for name, t in zip(tree._fields, tree)
                for pl in tree_leaves_with_path(t, f"{prefix}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [pl for i, t in enumerate(tree)
                for pl in tree_leaves_with_path(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and structurally equal
    ``rest``, visiting leaves in ``tree_leaves`` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``tree``'s structure refilled from a flat leaf list (tree order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
