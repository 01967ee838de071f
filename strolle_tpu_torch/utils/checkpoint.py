"""Checkpoint and resume of renderer state (port of
strolle_tpu/utils/checkpoint.py).

Carried state (a ``RenderState``, a reference-mode ``RefAccumulator``,
training parameters, or dicts, lists and tuples of them) is saved as
the flat list of its leaves: its tensors and numpy arrays, and its
Python ints, floats and bools (a RenderState's frame counter is one).
``restore`` rebuilds the structure from a target of the same shape, as
the structure is code, not data. The file is one ``torch.save`` under
the checkpoint's directory, read back with ``weights_only=True``.

Usage::

    save(path, {"state": render_state, "frame": 120})
    restored = restore(path, {"state": fresh_state, "frame": 0})
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

#: The file a checkpoint directory holds.
FILE = "state.pt"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, int, float, bool, np.generic))


def _leaves(tree) -> list:
    if _is_leaf(tree):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []  # None, strings and other structure


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return torch.as_tensor(next(it), dtype=tree.dtype).to(tree.device)
    if isinstance(tree, (np.ndarray, np.generic)):
        return np.asarray(next(it), dtype=tree.dtype)
    if _is_leaf(tree):
        return type(tree)(next(it))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: _rebuild(getattr(tree, f.name), it)
                     for f in dataclasses.fields(tree) if f.init}
        )
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree, key=str)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, it) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree


def _payload(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return x


def save(path: str | os.PathLike, state: Any, *, force: bool = True) -> None:
    """Writes ``state``'s leaves into directory ``path`` (made if
    missing); an existing checkpoint there is replaced unless ``force``
    is False, when it raises FileExistsError."""
    path = Path(path).resolve()
    target = path / FILE
    if target.exists() and not force:
        raise FileExistsError(f"checkpoint exists: {target}")
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (FILE + ".tmp")
    torch.save([_payload(x) for x in _leaves(state)], tmp)
    os.replace(tmp, target)


def restore(path: str | os.PathLike, target: Any) -> Any:
    """Reads a checkpoint written by ``save``. ``target`` supplies the
    structure (a fresh state of the same shape); every leaf takes the
    target leaf's dtype and device."""
    leaves = torch.load(Path(path).resolve() / FILE, weights_only=True)
    want = len(_leaves(target))
    if len(leaves) != want:
        raise ValueError(f"checkpoint has {len(leaves)} leaves, target has {want}")
    return _rebuild(target, iter(leaves))


def latest_step(root: str | os.PathLike) -> int | None:
    """For step-numbered layouts (``<root>/<step>/``): the newest step
    present, or None."""
    root = os.fspath(root)
    if not os.path.isdir(root):
        return None
    steps = [int(d) for d in os.listdir(root) if d.isdigit()]
    return max(steps) if steps else None
