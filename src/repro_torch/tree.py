"""Walks over nested containers of tensors (parameter trees, optimizer
states, checkpoints), in the reference's leaf order.

A tree is nested dicts, lists, tuples and NamedTuples; anything else is a
leaf, and ``None`` is an empty subtree.  Dict keys are taken in sorted
order and NamedTuples by field, as ``jax.tree_util`` takes them, so the
n-th leaf here is the n-th leaf of the reference's tree.
"""
from __future__ import annotations


def leaves_with_path(tree, path=()):
    """(path, leaf) pairs in the reference's order; a path is the tuple of
    dict keys, list or tuple indices and NamedTuple field names, as
    strings."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves in the reference's order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def rebuild(tree, it):
    """``tree``'s structure (dict key order included) with its leaves taken
    from the iterator ``it`` in the reference's order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, it) for v in tree)
    return next(it)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (of the same structure), as ``jax.tree.map``."""
    flat = zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))
    return rebuild(tree, (fn(*xs) for xs in flat))
