"""Trees as the reference's ``jax.tree`` flattens them.

A tree is nested dicts (walked in sorted key order), lists and tuples (in
order); anything else is a leaf (``None`` is an empty node, as in JAX).
``flatten`` returns the leaves and a structure that ``unflatten`` fills
again; ``describe`` prints that structure as ``str(jax.tree.structure(...))``
does, for checkpoint manifests written by either package.
"""
from __future__ import annotations

_LEAF = object()


def flatten(tree) -> tuple:
    """(leaves, structure) with the leaves in the reference's order."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if node is None:
            return None
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def unflatten(structure, leaves) -> object:
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return node

    out = build(structure)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def map(fn, tree, *rest):                               # noqa: A001
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure, leaf by leaf."""
    flat, structure = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(structure, [fn(*xs) for xs in zip(flat, *others)])


def describe(structure) -> str:
    """The structure as JAX prints a ``PyTreeDef``."""
    def text(node):
        if node is _LEAF:
            return "*"
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {text(v)}"
                                   for k, v in node.items()) + "}"
        inner = ", ".join(text(x) for x in node)
        if isinstance(node, tuple):
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return f"[{inner}]"

    return f"PyTreeDef({text(structure)})"
