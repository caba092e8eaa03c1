"""Trees in ``jax.tree_util``'s order, for the checkpoint and sync
modules.

The model's parameter trees (``models/params.py``) walk dicts in their
insertion order.  The wire format, the fragment layout and the checkpoint
files of the reference index leaves in ``jax.tree_util.tree_flatten``
order instead: dict keys sorted, recursively, ``None`` a node with no
leaves.  ``flatten`` gives that order, and ``str(treedef)`` the string
JAX prints for the same structure (``PyTreeDef({'a': [*, *], 'b':
None})``), which the checkpoint files carry.
"""
from __future__ import annotations


class TreeDef:
    """The structure of a tree: a leaf, ``None``, or a dict, list or
    tuple of sub-structures."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: str, keys=(), children=()):
        self.kind, self.keys, self.children = kind, tuple(keys), \
            tuple(children)

    def _fmt(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [c._fmt() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.keys, inner)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
            + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._fmt()})"

    __repr__ = __str__

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and str(self) == str(other)

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"too many leaves for {self}")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            x = next(it, _END)
            if x is _END:
                raise ValueError(f"too few leaves for {self}")
            return x
        if self.kind == "none":
            return None
        vals = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, vals))
        return vals if self.kind == "list" else tuple(vals)


_END = object()


def flatten(tree, is_leaf=None) -> tuple:
    """-> (leaves, treedef) in ``jax.tree_util.tree_flatten`` order."""
    leaves: list = []

    def rec(x):
        if is_leaf is not None and is_leaf(x):
            leaves.append(x)
            return TreeDef("leaf")
        if x is None:
            return TreeDef("none")
        if isinstance(x, dict):
            keys = sorted(x)
            return TreeDef("dict", keys, [rec(x[k]) for k in keys])
        if isinstance(x, (list, tuple)):
            return TreeDef("list" if isinstance(x, list) else "tuple", (),
                           [rec(v) for v in x])
        leaves.append(x)
        return TreeDef("leaf")

    treedef = rec(tree)
    return leaves, treedef


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def flatten_with_path(tree) -> list:
    """[(keystr, leaf)] in flatten order; ``keystr`` as
    ``jax.tree_util.keystr`` prints a path of dict keys and indices
    (``['blocks']['pos0']['norm1']``)."""
    out: list = []

    def rec(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                rec(x[k], path + f"[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                rec(v, path + f"[{i}]")
        else:
            out.append((path, x))

    rec(tree, "")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the parallel ``rest``;
    ``None`` nodes stay ``None`` (``jax.tree_util.tree_map``)."""
    leaves_, treedef = flatten(tree, is_leaf)
    others = []
    for r in rest:
        lr, td = flatten(r, is_leaf)
        if td != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {td}")
        others.append(lr)
    return treedef.unflatten([fn(*xs) for xs in zip(leaves_, *others)])
