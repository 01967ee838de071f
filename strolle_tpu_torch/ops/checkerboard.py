"""Checkerboard ray compaction (port of strolle_tpu/ops/checkerboard.py).

A checkerboarded pass touches one 2x1 checkerboard half: within row y
the active columns share one x parity. ``compact`` packs them into an
[H, W/2] grid for the trace and ``expand`` puts the results back. The
JAX package compacts only where the trace is expensive per ray (scenes
over BRUTE_FORCE_MAX_TRIS triangles); Cornell traces at full width.
"""

from __future__ import annotations

import torch

from ..utils.pytree import tree_map


def compaction_pays(scene, width: int) -> bool:
    """Compact exactly when the trace takes the big-scene route."""
    from .trace import BRUTE_FORCE_MAX_TRIS

    return width % 2 == 0 and scene.geometry.num_triangles > BRUTE_FORCE_MAX_TRIS


def row_parity(f: int, h: int, device, y0: int = 0) -> torch.Tensor:
    """[h] active x parity of the ``h`` rows from row ``y0`` for
    checkerboard frame key ``f``: active(x, y) <=> x % 2 == (f + y) % 2."""
    return (int(f) + torch.arange(y0, y0 + h, dtype=torch.int32, device=device)) % 2


def _rowcond(parity: torch.Tensor, ndim: int) -> torch.Tensor:
    return parity.reshape((-1,) + (1,) * (ndim - 1)) == 0


def compact(parity: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """[H, W(, C)] -> [H, W/2(, C)] keeping column x = 2c + parity[y]."""
    return torch.where(_rowcond(parity, arr.ndim), arr[:, 0::2], arr[:, 1::2])


def expand(parity: torch.Tensor, half: torch.Tensor, fill=0) -> torch.Tensor:
    """Inverse of ``compact``; inactive columns take ``fill``."""
    fill = torch.full_like(half, fill)
    cond = _rowcond(parity, half.ndim)
    even = torch.where(cond, half, fill)
    odd = torch.where(cond, fill, half)
    h, w2 = half.shape[:2]
    return torch.stack([even, odd], dim=2).reshape((h, 2 * w2) + half.shape[2:])


def compact_tree(parity, tree):
    return tree_map(lambda a: compact(parity, a), tree)


def expand_tree(parity, tree, fill=0):
    return tree_map(lambda a: expand(parity, a, fill), tree)


def paired_anyhit(trace_fn, scene, parity, a_rays, b_rays):
    """The two cross-visibility rays of a checkerboarded spatial pass as
    one trace of an [H, W] grid: the active half's A rays in the left
    half, its B rays in the right. Returns (a_occluded, b_occluded),
    False at inactive columns."""
    (a_o, a_d, a_len), (b_o, b_d, b_len) = a_rays, b_rays
    o = torch.cat([compact(parity, a_o), compact(parity, b_o)], dim=1)
    d = torch.cat([compact(parity, a_d), compact(parity, b_d)], dim=1)
    t = torch.cat([compact(parity, a_len), compact(parity, b_len)], dim=1)
    occ = trace_fn(scene, o, d, t)
    w2 = a_o.shape[1] // 2
    return expand(parity, occ[:, :w2], False), expand(parity, occ[:, w2:], False)
