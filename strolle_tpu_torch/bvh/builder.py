"""The flattened BVH (port of strolle_tpu/bvh/builder.py).

The binned-SAH build runs on the host in the C++ library
(``strolle_tpu_torch.native``), with cross-frame subtree reuse when given
a ``native.BvhContext``. ``build_bvh_numpy`` is the JAX package's
pure-numpy builder, kept as the SAH-quality oracle of the native one
(never as a fallback); ``sah_cost`` and ``pad_nodes`` serve the
dynamic-scene editor.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from .. import native

#: Most triangles in one leaf (``native/strolle_native.cpp`` MAX_LEAF_SIZE).
MAX_LEAF_SIZE = 8
#: SAH bins of the numpy builder.
SAH_BINS = 12


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


def build_bvh(positions: np.ndarray, device, ctx=None) -> tuple[BvhArrays, np.ndarray]:
    """Builds a BVH over triangles ``positions`` [T, 3, 3] with the native
    builder (incremental through ``ctx``, a ``native.BvhContext``, when
    given). Returns (arrays on ``device``, order): leaf ranges index the
    triangle arrays permuted by ``order``."""
    positions = np.asarray(positions, np.float32)
    out = native.bvh_build(positions) if ctx is None else ctx.build(positions)
    cmin, cmax, child, count, order, max_depth = out

    def t(a):
        return torch.tensor(a, device=device)

    return BvhArrays(t(cmin), t(cmax), t(child), t(count), max_depth), order


def _leaf_token(first: int) -> int:
    return -(first + 1)


def build_bvh_numpy(positions: np.ndarray, device) -> tuple[BvhArrays, np.ndarray]:
    """The JAX package's pure-numpy binned-SAH builder (12 bins, a median
    split where SAH says leaf but the range holds more than
    MAX_LEAF_SIZE triangles); same contract as ``build_bvh``."""
    positions = np.asarray(positions, np.float32)
    t = positions.shape[0]
    if t == 0:
        raise ValueError("build_bvh_numpy needs at least one triangle")
    tri_min = positions.min(axis=1)
    tri_max = positions.max(axis=1)
    centers = (tri_min + tri_max) * 0.5
    order = np.arange(t, dtype=np.int64)

    def half_area(bmin, bmax):
        e = np.maximum(bmax - bmin, 0.0)
        return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]

    def range_bounds(ids):
        return tri_min[ids].min(axis=0), tri_max[ids].max(axis=0)

    def find_split(ids):
        """(axis, threshold, cost) of the best binned split, or None."""
        n = len(ids)
        c = centers[ids]
        best = None
        for axis in range(3):
            lo = c[:, axis].min()
            hi = c[:, axis].max()
            if hi - lo <= 1e-12:
                continue
            scale = SAH_BINS * (1.0 - 1e-6) / (hi - lo)
            bins = np.minimum(((c[:, axis] - lo) * scale).astype(np.int64), SAH_BINS - 1)
            bin_counts = np.bincount(bins, minlength=SAH_BINS)
            bin_min = np.full((SAH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((SAH_BINS, 3), -np.inf, np.float32)
            for b in range(SAH_BINS):
                mask = bins == b
                if mask.any():
                    bin_min[b] = tri_min[ids][mask].min(axis=0)
                    bin_max[b] = tri_max[ids][mask].max(axis=0)
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(bin_counts)
            rcount = n - lcount
            for cut in range(SAH_BINS - 1):
                nl, nr = lcount[cut], rcount[cut]
                if nl == 0 or nr == 0:
                    continue
                cost = nl * half_area(lmin[cut], lmax[cut]) + nr * half_area(
                    rmin[cut + 1], rmax[cut + 1]
                )
                if best is None or cost < best[2]:
                    best = (axis, lo + (cut + 1) * (hi - lo) / SAH_BINS, cost)
        return best

    # per node: (child 0, child 1, left box, right box); a child is
    # (token, count, is_leaf)
    nodes_children: list = []
    out_order: list[np.ndarray] = []
    out_cursor = 0

    def build_range(ids):
        nonlocal out_cursor
        n = len(ids)
        split = None if n <= 1 else find_split(ids)
        make_leaf = split is None
        if not make_leaf:
            bmin, bmax = range_bounds(ids)
            if split[2] >= n * half_area(bmin, bmax) and n <= MAX_LEAF_SIZE:
                make_leaf = True
        if make_leaf and n > MAX_LEAF_SIZE:
            # SAH says leaf but the leaf would be too big: median split
            c = centers[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            left_mask = c[:, axis] <= np.median(c[:, axis])
            if left_mask.all() or not left_mask.any():
                left_mask = np.zeros(n, bool)
                left_mask[: n // 2] = True
            split = (axis, None, None, left_mask)
            make_leaf = False
        if make_leaf:
            first = out_cursor
            out_order.append(ids)
            out_cursor += n
            return (_leaf_token(first), n, True)
        if len(split) == 4:
            left_mask = split[3]
        else:
            axis, thresh, _ = split
            left_mask = centers[ids][:, axis] <= thresh
            if left_mask.all() or not left_mask.any():
                half = len(ids) // 2
                left_mask = np.zeros(len(ids), bool)
                left_mask[np.argsort(centers[ids][:, axis])[:half]] = True
        left_ids, right_ids = ids[left_mask], ids[~left_mask]
        node_id = len(nodes_children)
        nodes_children.append(None)
        c0 = build_range(left_ids)
        c1 = build_range(right_ids)
        nodes_children[node_id] = (c0, c1, *range_bounds(left_ids), *range_bounds(right_ids))
        return (node_id, 0, False)

    def depth_of(desc, d=1):
        if desc[2]:
            return d
        c0, c1, *_ = nodes_children[desc[0]]
        return max(depth_of(c0, d + 1), depth_of(c1, d + 1))

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100_000))
    try:
        root_desc = build_range(order)
        new_order = np.concatenate(out_order) if out_order else order
        if root_desc[2]:  # the whole scene in one leaf: a root over it
            bmin, bmax = tri_min.min(axis=0), tri_max.max(axis=0)
            nodes_children.append(
                ((root_desc[0], root_desc[1], True), (_leaf_token(0), 0, True),
                 bmin, bmax, bmin, bmax)
            )
            max_depth, root_id = 2, len(nodes_children) - 1
        else:
            max_depth, root_id = depth_of(root_desc), root_desc[0]
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(nodes_children)
    a_min = np.zeros((n_nodes, 2, 3), np.float32)
    a_max = np.zeros((n_nodes, 2, 3), np.float32)
    a_child = np.zeros((n_nodes, 2), np.int32)
    a_count = np.zeros((n_nodes, 2), np.int32)
    for i, (c0, c1, lmin, lmax, rmin, rmax) in enumerate(nodes_children):
        a_min[i, 0], a_max[i, 0] = lmin, lmax
        a_min[i, 1], a_max[i, 1] = rmin, rmax
        for k, (token, cnt, is_leaf) in enumerate((c0, c1)):
            a_child[i, k] = token
            a_count[i, k] = cnt if is_leaf else 0
    if root_id != 0:  # traversal starts at node 0
        _swap_nodes(a_min, a_max, a_child, a_count, 0, root_id)

    def tt(a):
        return torch.tensor(a, device=device)

    arrays = BvhArrays(tt(a_min), tt(a_max), tt(a_child), tt(a_count), int(max_depth) + 2)
    return arrays, new_order


def _swap_nodes(cmin, cmax, child, count, a, b):
    for arr in (cmin, cmax, child, count):
        arr[[a, b]] = arr[[b, a]]
    internal = (child >= 0) & (count == 0)
    to_a = internal & (child == a)
    to_b = internal & (child == b)
    child[to_a] = b
    child[to_b] = a


def sah_cost(arrays: BvhArrays) -> float:
    """Total SAH cost (the sum over leaf children of count x half area),
    the build-quality measure of the tests."""
    cmin = arrays.child_min.detach().cpu().numpy()
    cmax = arrays.child_max.detach().cpu().numpy()
    count = arrays.child_count.detach().cpu().numpy()
    e = np.maximum(cmax - cmin, 0.0)
    ha = e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]
    return float((ha * count).sum())


def pad_nodes(arrays: BvhArrays, capacity: int) -> BvhArrays:
    """The node arrays padded to ``capacity`` rows with empty leaves
    ([inf, -inf] boxes, count 0, child -1) that no traversal visits, so
    that an edited scene keeps its shapes across rebuilds."""
    n = arrays.num_nodes
    if capacity <= n:
        return arrays
    pad = capacity - n
    dev = arrays.child.device
    inf = torch.full((pad, 2, 3), float("inf"), dtype=torch.float32, device=dev)
    return BvhArrays(
        child_min=torch.cat([arrays.child_min, inf]),
        child_max=torch.cat([arrays.child_max, -inf]),
        child=torch.cat([arrays.child, torch.full((pad, 2), -1, dtype=torch.int32, device=dev)]),
        child_count=torch.cat(
            [arrays.child_count, torch.zeros((pad, 2), dtype=torch.int32, device=dev)]
        ),
        max_depth=arrays.max_depth,
    )
