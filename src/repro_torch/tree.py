"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port's counterpart of the parts of ``jax.tree_util`` that the
reference uses.  Every walk visits a dict's keys in sorted order, as JAX
flattens dicts, so that leaf lists line up with the reference's: the
checkpoint's leaf names and the f32 sum in ``adamw.global_norm`` run in
the reference's order.  A NamedTuple's fields and a sequence's items keep
their order; ``None`` is an empty subtree with no leaves, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> Any:
    """(key, child) pairs of an inner node, in JAX's order; None for a
    leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_flatten_with_names(tree, prefix: Tuple[str, ...] = ()
                            ) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs; a name joins the dict keys, field names and
    sequence indices on the path with ``/`` (``"leaf"`` for a bare leaf),
    as the reference's ``ckpt._flatten_with_names`` does."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix) or "leaf", tree)]
    out = []
    for key, child in kids:
        out += tree_flatten_with_names(child, prefix + (key,))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are ``leaves``, in
    ``tree_leaves(like)`` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf (what the checkpoint
    manifest records in place of JAX's treedef repr)."""
    if tree is None:
        return "None"
    kids = _children(tree)
    if kids is None:
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(v)}" for k, v in kids) + "}"
    if hasattr(tree, "_fields"):
        inner = ", ".join(f"{k}={describe(v)}" for k, v in kids)
        return f"{type(tree).__name__}({inner})"
    inner = ", ".join(describe(v) for _, v in kids)
    return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
