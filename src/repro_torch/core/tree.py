"""Nested containers of tensors, walked as the reference walks its pytrees.

The training state (train/step.py), the optimizer (optim/adamw.py), the
gradient compressor (parallel/compression.py) and the checkpoints
(checkpoint/manager.py) hold trees: dicts, lists, tuples, named tuples and
dataclasses around tensor (or numpy) leaves. They are walked in JAX's
order (a dict's keys sorted, a sequence's items in order, a dataclass's or
named tuple's fields in order) and a leaf's path is named as the
reference's checkpoint keys name it: a dict key or a sequence index as it
prints, a field as ``.name``, joined by ``/`` (``.params/groups/0/0/mixer/wq``,
``.opt/.m/embed``, ``.step``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _children(node) -> List[Tuple[str, Any]]:
    """(path element, child) of a container node, in JAX's order; [] for a
    leaf (see :func:`_atom`)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [("." + f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return []


def _atom(node) -> bool:
    """Not a container: a leaf whatever ``is_leaf`` says."""
    return not (isinstance(node, (dict, list, tuple)) or (
        dataclasses.is_dataclass(node) and not isinstance(node, type)))


def paths(tree, prefix: str = "", is_leaf: Optional[Callable] = None
          ) -> List[Tuple[str, Any]]:
    """Every leaf with its path, in JAX's flattening order (``is_leaf``:
    a node it holds true of is a leaf too, as JAX's)."""
    if _atom(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(paths(child, f"{prefix}/{key}" if prefix else key,
                         is_leaf))
    return out


def leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    return [leaf for _, leaf in paths(tree, is_leaf=is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` (and the matching nodes of each
    tree in ``rest``, of the same structure down to ``tree``'s leaves),
    keeping the structure; the leaves are visited in :func:`paths` order.
    ``is_leaf`` as in :func:`paths`."""
    if _atom(tree) or (is_leaf is not None and is_leaf(tree)):
        return fn(tree, *rest)

    def sub(node, *others):
        return tree_map(fn, node, *others, is_leaf=is_leaf)

    if isinstance(tree, dict):      # leaves visited in :func:`paths` order
        return {k: sub(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(sub(getattr(tree, f),
                                *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        f.name: sub(getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(tree)})


def unflatten(like, leaves_in_order) -> Any:
    """A tree of ``like``'s structure holding ``leaves_in_order`` (in
    :func:`paths` order)."""
    it = iter(leaves_in_order)
    return tree_map(lambda _: next(it), like)


def to_host(x) -> np.ndarray:
    """A leaf as a host numpy copy (a bf16 tensor as f32: numpy has no
    bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        if x.device.type != "cpu":     # the copy to the host is the snapshot
            return x.cpu().numpy()
    return np.array(x, copy=True)
