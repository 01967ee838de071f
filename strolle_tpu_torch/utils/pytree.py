"""Mapping over the port's nested state: frozen dataclasses of tensors,
tuples, lists and dicts (the JAX package's pytrees)."""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree):
    """``fn`` applied to every tensor of ``tree``; other values (Python
    ints, flags) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x) for x in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree
