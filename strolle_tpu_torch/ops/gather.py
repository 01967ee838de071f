"""Screen-space gathers (port of strolle_tpu/ops/gather.py).

The JAX package shapes every gather for the TPU: rows fetched by
one-hot matmuls, fields packed into one f32 matrix for a row-batched
take, integer fields carried through f32 by value. On the GPU a gather
is plain indexing, which is exact for every dtype (int64 RNG states
included), so each function here indexes the tensors directly and
returns the same values.
"""

from __future__ import annotations

import torch

from ..utils.pytree import tree_map


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, K] fetched at idx [...] -> [..., K]."""
    return table[idx.long()]


def _take(a: torch.Tensor, flat_idx: torch.Tensor, shape) -> torch.Tensor:
    h, w = a.shape[:2]
    return a.reshape((h * w,) + a.shape[2:])[flat_idx].reshape(tuple(shape) + a.shape[2:])


def gather_at(pos_y, pos_x, *arrays):
    """Several [H, W(, C)] arrays fetched at per-pixel integer coords
    (in bounds; callers clamp)."""
    return take_screen(*pack_screen(*arrays), pos_y, pos_x)


def pack_screen(*arrays):
    """[H, W(, C)] arrays as (flat, specs) for ``take_screen``: each array
    viewed as [H*W(, C)] in its own dtype, and (H, W). The JAX package
    packs them into one f32 matrix for a single take; here each is
    indexed on its own, exactly."""
    h, w = arrays[0].shape[:2]
    return tuple(a.reshape((h * w,) + a.shape[2:]) for a in arrays), (h, w)


def take_screen(flat, specs, pos_y, pos_x):
    """The arrays that ``pack_screen`` packed, fetched at per-pixel integer
    coords (in bounds; callers clamp): a list of [*pos_y.shape(, C)] in
    their dtypes."""
    _, w = specs
    idx = (pos_y.long() * w + pos_x.long()).reshape(-1)
    return [a[idx].reshape(tuple(pos_y.shape) + a.shape[1:]) for a in flat]


def gather_tree(tree, pos_y, pos_x):
    """A whole screen-space tree (Surface, reservoirs, tuples of them)
    fetched at per-pixel integer coords."""
    idx = None

    def take(a):
        nonlocal idx
        if idx is None:
            idx = (pos_y.long() * a.shape[1] + pos_x.long()).reshape(-1)
        return _take(a, idx, pos_y.shape)

    return tree_map(take, tree)


def take_bilinear(arrays, py, px):
    """The 4 bilinear corner taps (floor/ceil per axis) of several screen
    arrays at fractional coords, each corner clamped to the screen.

    Returns (taps, fy, fx): ``taps[corner][field]`` in corner order
    (floor, floor), (floor_y, ceil_x), (ceil_y, floor_x), (ceil_y, ceil_x);
    the same values as the JAX package's shifted-variant take (its ceil
    tap is the clamped floor + 1)."""
    h, w = arrays[0].shape[:2]
    fy = torch.floor(py).to(torch.int32)
    fx = torch.floor(px).to(torch.int32)
    y0 = torch.clamp(fy, 0, h - 1).long()
    x0 = torch.clamp(fx, 0, w - 1).long()
    y1 = torch.clamp(fy + 1, 0, h - 1).long()
    x1 = torch.clamp(fx + 1, 0, w - 1).long()
    taps = tuple(
        gather_at(yy, xx, *arrays) for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))
    )
    return taps, fy, fx
