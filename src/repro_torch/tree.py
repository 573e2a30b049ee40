"""Trees: the nested dicts, lists and tuples the port keeps its params,
gradients, optimizer states and checkpoints in (the reference's pytrees).

One walker serves every use.  ``None`` and ``Axes`` (the logical axis
names of a param leaf) hold no leaf, as in the reference; of the other
values, those that ``is_leaf`` accepts are leaves (by default the
tensors), and the rest are kept as they are.  Leaves are visited in the
reference's order: dict keys sorted, lists and tuples in order.
"""
from __future__ import annotations

import torch


class Axes(tuple):
    """Logical axis names of a param leaf (the reference's ``Axes``, a
    pytree node without leaves there; names only here)."""


def _is_tensor(t) -> bool:
    return isinstance(t, torch.Tensor)


def _is_leaf(t, is_leaf) -> bool:
    return t is not None and not isinstance(t, (dict, list, tuple)) \
        and is_leaf(t)


def flatten(tree, is_leaf=_is_tensor):
    """(the leaves of ``tree`` in the reference's order, its structure in
    the reference's ``PyTreeDef(...)`` notation)."""
    out = []

    def walk(t):
        if isinstance(t, Axes):
            return f"CustomNode(Axes[{tuple(t)!r}], [])"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            parts = [walk(v) for v in t]
            if isinstance(t, list):
                return "[" + ", ".join(parts) + "]"
            return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "")\
                + ")"
        if _is_leaf(t, is_leaf):
            out.append(t)
            return "*"
        return repr(t)
    spec = walk(tree)
    return out, f"PyTreeDef({spec})"


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in the reference's flatten order."""
    return flatten(tree)[0]


def unflatten(like, new_leaves, is_leaf=_is_tensor):
    """``like`` with its leaves replaced, in flatten order, by
    ``new_leaves``; everything else kept."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)) and not isinstance(t, Axes):
            return type(t)(build(v) for v in t)
        if _is_leaf(t, is_leaf):
            return next(it)
        return t
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest)`` at every leaf of ``tree``; the trees
    in ``rest`` have ``tree``'s leaves in the same order."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
