"""The flattened BVH (port of strolle_tpu/bvh/builder.py, native route).

The binned-SAH build runs on the host in the C++ library
(``strolle_tpu_torch.native``); the numpy builder of the JAX package
(``build_bvh_numpy``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import native

#: Most triangles in one leaf (``native/strolle_native.cpp`` MAX_LEAF_SIZE).
MAX_LEAF_SIZE = 8


@dataclasses.dataclass(frozen=True)
class BvhArrays:
    """Flattened 2-wide BVH. ``child[n, k] >= 0`` is an internal node id;
    ``child[n, k] < 0`` encodes a leaf whose triangles are the reordered
    rows ``[first, first + count)`` with ``first = -(child + 1)``."""

    child_min: torch.Tensor  # f32[N, 2, 3]
    child_max: torch.Tensor  # f32[N, 2, 3]
    child: torch.Tensor  # i32[N, 2]
    child_count: torch.Tensor  # i32[N, 2]
    max_depth: int = 32

    @property
    def num_nodes(self) -> int:
        return self.child.shape[0]

    @functools.cached_property
    def node_rows(self) -> torch.Tensor:
        """The [N, 16] node rows of the BVH kernels (``bvh_kernels.pack_nodes``),
        packed once per BVH."""
        from ..ops.kernels.bvh_kernels import pack_nodes

        return pack_nodes(self)


def build_bvh(positions: np.ndarray, device) -> tuple[BvhArrays, np.ndarray]:
    """Builds a BVH over triangles ``positions`` [T, 3, 3] with the native
    builder. Returns (arrays on ``device``, order): leaf ranges index the
    triangle arrays permuted by ``order``."""
    cmin, cmax, child, count, order, max_depth = native.bvh_build(positions)

    def t(a):
        return torch.as_tensor(a, device=device)

    return BvhArrays(t(cmin), t(cmax), t(child), t(count), max_depth), order
