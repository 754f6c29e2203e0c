"""Nested dict / list trees of tensors: the port's stand-in for `jax.tree`.

The training state (params, optimizer moments, masks) keeps the
reference's pytree structure: nested dicts whose ``blocks`` leaves are
layer-stacked ``(L, ...)``.  Leaves are visited in `jax.tree` order —
dict keys sorted, lists in order, ``None`` an empty subtree — so a leaf's
index and name (`leaves_with_names`) are the reference's, which is what
lets a checkpoint cross between the two packages.
"""
from __future__ import annotations


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves_with_names(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) in `jax.tree` order; names as the reference's
    checkpoint manifest writes them (``['blocks']/['attn']/['wq']/['w']``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(f"['{k}']", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += leaves_with_names(sub, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_names(tree)]


def map(fn, tree, *rest):  # noqa: A001 (mirrors jax.tree.map)
    """``fn(leaf, *rest_leaves)`` over `tree`'s leaves; a ``None`` leaf of
    `tree` stays ``None``, and where a tree of `rest` is ``None`` (or lacks
    the subtree) its leaves arrive as ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, v, *(_child(r, k) for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(_child(r, i) for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _child(tree, key):
    if tree is None or not _is_node(tree):
        return None
    if isinstance(tree, dict):
        return tree.get(key)
    return tree[key] if key < len(tree) else None


def unflatten(tree, new_leaves) -> object:
    """`tree`'s structure holding `new_leaves` (in `leaves(tree)` order)."""
    names = [name for name, _ in leaves_with_names(tree)]
    new_leaves = list(new_leaves)
    if len(new_leaves) != len(names):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {len(names)}")
    return _rebuild(tree, dict(zip(names, new_leaves)), "")


def _rebuild(tree, by_name, prefix):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_name, f"{prefix}/['{k}']" if prefix else f"['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, by_name, f"{prefix}/[{i}]" if prefix else f"[{i}]")
                          for i, v in enumerate(tree))
    return by_name[prefix]
