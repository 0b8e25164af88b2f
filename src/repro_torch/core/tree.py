"""Map over the port's pytrees: nested dicts and lists of tensors."""
from __future__ import annotations


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested lists/tuples/dicts."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in the order ``jax.tree.leaves`` gives (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]
