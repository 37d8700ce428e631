"""The few ``jax.tree`` functions the port needs, over nests of dicts,
lists and tuples.

Leaves are numbered in JAX's flatten order: a dict's values by sorted
key, lists and tuples in order; ``None`` is a node with no leaves, as in
JAX. Anything else is a leaf. The checkpoint format numbers its leaf
files this way, so either package reads the other's trees.
"""
from __future__ import annotations

_LEAF = object()


def tree_flatten(tree, is_leaf=None):
    """(leaves in JAX's order, treedef): the treedef is ``tree`` with each
    leaf replaced by a marker, for ``tree_unflatten``. ``is_leaf(t)``
    true makes ``t`` a leaf whatever its type (a spec tuple)."""
    leaves = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return _LEAF
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        leaves.append(t)
        return _LEAF
    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` (``tree_flatten``'s) holding ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is _LEAF:
            return next(it)
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return type(t)(build(v) for v in t)
    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree has places")
    return out


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees of ``rest`` (same structure), in one tree of ``tree``'s shape.
    ``is_leaf`` applies to ``tree`` only."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(t)[0] for t in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))``: what the reference
    writes as a checkpoint's ``treedef``."""
    def fmt(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(fmt(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(fmt(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"
