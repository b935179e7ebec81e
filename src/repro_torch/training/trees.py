"""Nested containers of tensors, walked in `jax.tree_util`'s order.

The reference's trees are pytrees; the port's are a `ParamTree` (the
model's parameters) or nested dicts of tensors mirroring it (gradients,
optimizer moments), with tuples and NamedTuples around them
(``(params, AdamWState(step, m, v))``).  Both packages number a tree's
leaves the same way, which is what lets each restore the other's
checkpoints: dict keys sorted at every level (a `ParamTree` is a dict;
its insertion order is not sorted), tuple and list items in order, None
holds no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

from repro_torch.models.layers import ParamTree


def _is_map(x) -> bool:
    return isinstance(x, (dict, ParamTree))


def items(tree, prefix: tuple = ()) -> Iterator[Tuple[tuple, Any]]:
    """(key path, leaf) of a nest of dicts / ParamTrees, keys sorted."""
    if not _is_map(tree):
        yield prefix, tree
        return
    for k in sorted(tree.keys()):
        yield from items(tree[k], prefix + (k,))


def build(pairs) -> dict:
    """The nested dict of (key path, value) pairs."""
    out: dict = {}
    for path, val in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return out


def tree_map(fn: Callable, tree, *rest) -> dict:
    """fn over the leaves of `tree` (and the leaves at the same paths of
    `rest`), as a nested dict."""
    others = [dict(items(r)) for r in rest]
    return build((path, fn(leaf, *(o[path] for o in others)))
                 for path, leaf in items(tree))


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in `jax.tree_util.tree_flatten`'s order."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if _is_map(t):
            keys = sorted(t.keys())
            kind = "params" if isinstance(t, ParamTree) else "dict"
            return (kind, keys, [walk(t[k]) for k in keys])
        if isinstance(t, (tuple, list)):
            return (type(t), None, [walk(x) for x in t])
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> Any:
    """The tree of `treedef` with `leaves` in order (a "params" node
    becomes a `ParamTree` again)."""
    it = iter(leaves)

    def make(d):
        if d[0] == "none":
            return None
        if d[0] == "leaf":
            return next(it)
        kind, keys, kids = d
        vals = [make(k) for k in kids]
        if kind == "params":
            return ParamTree(dict(zip(keys, vals)))
        if kind == "dict":
            return dict(zip(keys, vals))
        if hasattr(kind, "_fields"):         # a NamedTuple
            return kind(*vals)
        return kind(vals)

    out = make(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def describe(treedef) -> str:
    """A readable form of a treedef (checkpoints' meta.json)."""
    if treedef[0] in ("none", "leaf"):
        return "*" if treedef[0] == "leaf" else "None"
    kind, keys, kids = treedef
    if keys is None:
        name = getattr(kind, "__name__", str(kind))
        return f"{name}(" + ", ".join(describe(k) for k in kids) + ")"
    return "{" + ", ".join(f"{k!r}: {describe(c)}"
                           for k, c in zip(keys, kids)) + "}"
