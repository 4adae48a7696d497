"""Nested parameter trees: dicts, lists, tuples and NamedTuples of tensors
(the port's stand-in for the reference's ``jax.tree_util``).

Leaves come in JAX's order (dict keys sorted, sequences and NamedTuple
fields in order), and :func:`keystr` spells a path as the reference's
checkpoint keys do: ``['key']`` for a dict entry, ``[i]`` for a sequence
element, ``.name`` for a NamedTuple field, joined by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Path = Tuple[Tuple[str, Any], ...]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """``[(key, child)]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(("key", k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(("attr", f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(("idx", i), c) for i, c in enumerate(node)]
    return None


def _walk(node, path: Path, out: List[Tuple[Path, Any]]) -> None:
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, path + (key,), out)


def leaves_with_path(tree) -> List[Tuple[Path, Any]]:
    """Every leaf with its path, in JAX's flattening order.  (A module-level
    walk: a recursive closure would be a reference cycle keeping every
    leaf alive until the garbage collector runs.)"""
    out: List[Tuple[Path, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def keystr(path: Path) -> str:
    """The reference checkpoint's key of ``path``:
    ``[0]/['segments']/[0]/['attn']/['wq']/['w']``, ``[1]/.step``."""
    parts = []
    for kind, k in path:
        parts.append(f"['{k}']" if kind == "key" else
                     f".{k}" if kind == "attr" else f"[{k}]")
    return "/".join(parts)


def pathstr(path: Path) -> str:
    """A plain ``a/b/0/c`` spelling of ``path``."""
    return "/".join(str(k) for _, k in path)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; leaves are visited in
    :func:`leaves_with_path`'s order."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    mapped = [tree_map(fn, c, *(r[i] for r in rest))
              for i, (_, c) in enumerate(kids)]
    if _is_namedtuple(tree):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def unflatten_like(like, new_leaves: List[Any]):
    """A tree shaped like ``like`` whose leaves, in order, are
    ``new_leaves``."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def host_copy(leaf) -> np.ndarray:
    """A numpy copy of a tensor (any device) or array: a snapshot that a
    later in-place update of ``leaf`` does not change."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        return leaf.numpy().copy() if leaf.device.type == "cpu" else \
            leaf.cpu().numpy()
    return np.array(leaf)
