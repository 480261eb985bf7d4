"""Parameter and optimizer-state trees, flattened as JAX flattens pytrees.

A tree is a leaf, ``None`` (no leaves), a dict (children in sorted key
order), a list or plain tuple (in order) or a NamedTuple (its fields in
order).  Leaves are tensors, numpy arrays and host scalars (the
optimizers' ``step`` is a host int).  ``paths`` names each leaf with the
string ``jax.tree_util.tree_flatten_with_path`` gives for the same tree
(``"/".join(str(key))``): ``['name']`` for a dict key, ``[i]`` for a list
or tuple position, ``.field`` for a NamedTuple field — so a checkpoint
written by either package names its leaves the same way, e.g.
``[0]/['mlp']/[0]/['w']`` and ``[1]/.mu/['table']`` for ``(params,
AdamWState)``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

Tree = Any


class Spec(NamedTuple):
    """The structure of a flattened tree: ``kind`` is ``leaf``, ``none``,
    ``dict``, ``list``, ``tuple`` or ``namedtuple``; ``meta`` the sorted
    keys (dict) or the NamedTuple class; ``children`` their specs."""
    kind: str
    meta: Any
    children: tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _node(tree) -> tuple[str, Any, list, list]:
    """(kind, meta, children, path keys) of one node."""
    if tree is None:
        return "none", None, [], []
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", tuple(keys), [tree[k] for k in keys], [f"[{k!r}]" for k in keys]
    if _is_namedtuple(tree):
        return ("namedtuple", type(tree), list(tree),
                [f".{name}" for name in tree._fields])
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return kind, None, list(tree), [f"[{i}]" for i in range(len(tree))]
    return "leaf", None, [], []


def flatten(tree: Tree) -> tuple[list, Spec]:
    """(leaves in JAX's order, the spec ``unflatten`` rebuilds from)."""
    leaves: list = []

    def walk(node) -> Spec:
        kind, meta, children, _ = _node(node)
        if kind == "leaf":
            leaves.append(node)
            return Spec("leaf", None, ())
        return Spec(kind, meta, tuple(walk(c) for c in children))

    return leaves, walk(tree)


def unflatten(spec: Spec, leaves) -> Tree:
    it = iter(leaves)

    def build(s: Spec):
        if s.kind == "leaf":
            return next(it)
        if s.kind == "none":
            return None
        kids = [build(c) for c in s.children]
        if s.kind == "dict":
            return dict(zip(s.meta, kids))
        if s.kind == "namedtuple":
            return s.meta(*kids)
        return kids if s.kind == "list" else tuple(kids)

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def leaves(tree: Tree) -> list:
    return flatten(tree)[0]


def paths(tree: Tree) -> list[tuple[str, Any]]:
    """(JAX path string, leaf) for every leaf, in order."""
    out: list = []

    def walk(node, prefix: list):
        kind, _, children, keys = _node(node)
        if kind == "leaf":
            out.append(("/".join(prefix), node))
            return
        for key, child in zip(keys, children):
            walk(child, prefix + [key])

    walk(tree, [])
    return out


def flatten_up_to(spec: Spec, tree: Tree) -> list:
    """The leaves of ``tree`` where ``spec`` has leaves, for a tree of the
    same structure whose leaves may themselves be trees (adafactor's
    per-leaf ``{'vr', 'vc'}`` stats), as JAX's ``flatten_up_to``."""
    out: list = []

    def walk(s: Spec, node):
        if s.kind == "leaf":
            out.append(node)
            return
        kind, meta, children, _ = _node(node)
        if kind != s.kind or (kind == "dict" and meta != s.meta) \
                or len(children) != len(s.children):
            raise ValueError(f"tree structure differs: {kind} against {s.kind}")
        for cs, child in zip(s.children, children):
            walk(cs, child)

    walk(spec, tree)
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilt in ``tree``'s structure."""
    flat, spec = flatten(tree)
    others = [flatten_up_to(spec, r) for r in rest]
    return unflatten(spec, [fn(x, *(o[i] for o in others)) for i, x in enumerate(flat)])
