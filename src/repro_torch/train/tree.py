"""Trees in the JAX package's leaf order.

``jax.tree.flatten`` visits dict keys in sorted order, lists and tuples
in order, NamedTuple fields in field order; ``None`` is an empty subtree
and anything else (a tensor, a numpy array, a python ``int``/``float``)
is a leaf.  The port's model code walks trees with
``models.qweight.tree_map``, in dict insertion order; training needs the
reference's order, because the checkpoint's ``a{i}`` names index the
leaves in it and the optimizer's float32 global norm sums them in it.
"""

from __future__ import annotations

_LEAF = "*"


class TreeDef:
    """The structure of a tree without its leaves; equal structures
    compare equal, and ``str`` renders it as ``jax`` does (``*`` for a
    leaf)."""

    __slots__ = ("node",)

    def __init__(self, node):
        self.node = node

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self.node == other.node

    def __str__(self):
        return f"PyTreeDef({_render(self.node)})"

    __repr__ = __str__


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_flatten(tree):
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s order."""
    leaves = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return (dict, keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = type(t) if _is_namedtuple(t) else \
                (list if isinstance(t, list) else tuple)
            return (kind, None, tuple(walk(v) for v in t))
        leaves.append(t)
        return _LEAF

    node = walk(tree)
    return leaves, TreeDef(node)


def tree_unflatten(treedef: TreeDef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flatten order (dicts
    come back with their keys sorted, as ``jax.tree.unflatten`` builds
    them)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == _LEAF:
            return next(it)
        kind, keys, kids = node
        vals = [build(k) for k in kids]
        if kind is dict:
            return dict(zip(keys, vals))
        if kind in (list, tuple):
            return kind(vals)
        return kind(*vals)

    out = build(treedef.node)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of the same structure), as ``jax.tree.map``."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} != {r_def}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _render(node) -> str:
    if node is None:
        return "None"
    if node == _LEAF:
        return "*"
    kind, keys, kids = node
    parts = [_render(k) for k in kids]
    if kind is dict:
        return "{" + ", ".join(f"{k!r}: {p}"
                               for k, p in zip(keys, parts)) + "}"
    if kind is list:
        return "[" + ", ".join(parts) + "]"
    if kind is tuple:
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    return f"{kind.__name__}(" + ", ".join(
        f"{f}={p}" for f, p in zip(kind._fields, parts)) + ")"
