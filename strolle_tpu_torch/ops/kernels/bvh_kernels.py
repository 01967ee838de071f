"""BVH closest hit and any hit (port of strolle_tpu/ops/pallas/bvh_kernels.py:
``bvh_trace_surface_pallas`` and ``bvh_trace_anyhit_pallas``).

Nodes are [N, 16] rows (``pack_nodes``): lmin(3) lmax(3) rmin(3) rmax(3)
child0 child1 count0 count1, the children and counts as exact-integer
floats; a child < 0 is a leaf of rows [first, first + count) with
first = -(child + 1). Triangles are the [T', 28] ``pack_geometry`` rows
in BVH order.

Each ray walks the tree with its own stack of MAX_STACK node ids (the
root pre-pushed): it pops a node, slab-tests both children against its
best t, intersects leaf children inline (child 0, then child 1, up to
MAX_LEAF rows each, a hit kept on strict ``<``), and pushes interior
children far first, so that the near one (the smaller entry distance,
ties to child 0) pops first; the stack pointer is clamped at
MAX_STACK - 1 as in the TPU kernel. Closest hit (kernel 10) starts at
t = +inf and resolves the winner's normal, uv and material id from its
row; any hit (kernel 11) walks against t_max, stops at its first
occluder, and a ray with t_max <= 0 never occludes.

The TPU kernels walk a 32x128 ray tile with one shared stack and order
children by the tile's nearest entry; here, as in the reference
(strolle-gpu/src/ray.rs:114-266) and the JAX package's jnp traversal,
each ray walks alone. The CUDA kernels (``csrc/bvh_kernels.cu``) run one
thread per ray; each wrapper below runs its plain PyTorch version for
CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from ..intersect import front_passes, ray_triangle_edges, safe_inv_dir, slab
from . import cuda_lib
from .trace_kernels import resolve_winner

MAX_STACK = 48
MAX_LEAF = 8  # bvh/builder.py MAX_LEAF_SIZE
#: The entry distance of a child box the ray misses, for the near-first order.
_BIG = 1e30


def pack_nodes(bvh) -> torch.Tensor:
    """BvhArrays -> [N, 16] rows."""
    return torch.cat(
        [
            bvh.child_min[:, 0],
            bvh.child_max[:, 0],
            bvh.child_min[:, 1],
            bvh.child_max[:, 1],
            bvh.child.to(torch.float32),
            bvh.child_count.to(torch.float32),
        ],
        dim=-1,
    ).contiguous()


def _walk(node_rows, of, df, best, live, work, on_leaf_row):
    """The per-ray stack walk both plain versions share, vectorised over
    the rays in ``live`` whose stacks are not empty. ``best`` [R] bounds
    the slab tests. ``on_leaf_row(ids, rows_idx)`` tests rays ``ids``
    against one row each and returns a mask of the rays that leave the
    walk (or None). ``work`` [R, 2] or [R, 3] (optional) counts box and
    triangle tests (a third column: ``on_leaf_row`` adds the tests whose
    first half passes, ``front_passes``)."""
    r = of.shape[0]
    dev = of.device
    inv = safe_inv_dir(df)
    stack = torch.zeros((r, MAX_STACK), dtype=torch.int64, device=dev)
    ptr = torch.ones(r, dtype=torch.int64, device=dev)
    while live.numel():
        p = ptr[live] - 1
        row = node_rows[stack[live, p]]  # [L, 16]
        if work is not None:
            work[live, 0] += 2
        o_l, inv_l, bt = of[live], inv[live], best[live]
        hit0, tn0 = slab(row[:, 0:3], row[:, 3:6], o_l, inv_l, bt)
        hit1, tn1 = slab(row[:, 6:9], row[:, 9:12], o_l, inv_l, bt)
        child = row[:, 12:14].to(torch.int64)
        count = torch.clamp(row[:, 14:16].to(torch.int64), max=MAX_LEAF)
        walking = torch.ones_like(hit0)
        for k, hit in ((0, hit0), (1, hit1)):
            leaf = (hit & walking & (child[:, k] < 0)).nonzero()[:, 0]
            first = -(child[leaf, k] + 1)
            cnt = count[leaf, k]
            for j in range(MAX_LEAF):
                sel = (j < cnt).nonzero()[:, 0]
                if sel.numel() == 0:
                    break
                ids = live[leaf[sel]]
                if work is not None:
                    work[ids, 1] += 1
                stop = on_leaf_row(ids, first[sel] + j)
                if stop is not None:
                    walking[leaf[sel[stop]]] = False
                    cnt = torch.where(torch.isin(leaf, leaf[sel[stop]]), 0, cnt)
        # interior children: far pushed first, so the near one pops first
        push0 = hit0 & (child[:, 0] >= 0)
        push1 = hit1 & (child[:, 1] >= 0)
        near0 = torch.where(hit0, tn0, _BIG) <= torch.where(hit1, tn1, _BIG)
        far = (torch.where(near0, child[:, 1], child[:, 0]), torch.where(near0, push1, push0))
        near = (torch.where(near0, child[:, 0], child[:, 1]), torch.where(near0, push0, push1))
        for c, go in (far, near):
            rows = go.nonzero()[:, 0]
            stack[live[rows], torch.clamp(p[rows], max=MAX_STACK - 1)] = c[rows]
            p = p + go.long()
        p = torch.where(walking, torch.clamp(p, max=MAX_STACK - 1), 0)
        ptr[live] = p
        live = live[p > 0]


def _aligned(*tables):
    """The node and triangle tables as the kernels read them, in 16-byte
    loads: a table that does not start on a 16-byte boundary (a view into
    another tensor) is copied."""
    return tuple(t.clone() if t.is_contiguous() and t.data_ptr() % 16 else t for t in tables)


def _count_fronts(work, ids, u, det) -> None:
    """Adds the tests of rays ``ids`` (one row each) whose first half
    passes to ``work``'s third column, where it has one."""
    if work is not None and work.shape[1] > 2:
        work[ids, 2] += front_passes(u, det).to(torch.int32)


def bvh_trace_surface_plain(node_rows, geom_rows, o, d, work=None):
    """Plain version of kernel 10: (t, tri, u, v, normal, uv, mat_id) over
    o's batch shape; t = +inf, tri = -1 and zeros on a miss. ``work``
    [R, 2] int32 (optional) accumulates each ray's box and triangle
    tests; [R, 3] also the tests whose first half passes."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    r = of.shape[0]
    best = torch.full((r,), math.inf, dtype=torch.float32, device=o.device)
    btri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)

    def on_leaf_row(ids, rows_idx):
        row = geom_rows[rows_idx]
        t, u, v, det = ray_triangle_edges(of[ids], df[ids], row[:, 0:3], row[:, 3:6],
                                          row[:, 6:9])
        _count_fronts(work, ids, u, det)
        better = t < best[ids]
        w = ids[better]
        best[w] = t[better]
        btri[w] = rows_idx[better].to(torch.int32)
        bu[w] = u[better]
        bv[w] = v[better]
        return None

    _walk(node_rows, of, df, best, torch.arange(r, device=o.device), work, on_leaf_row)
    normal, uv, mat = resolve_winner(geom_rows, df, btri, bu, bv)
    return (best.reshape(batch), btri.reshape(batch), bu.reshape(batch), bv.reshape(batch),
            normal.reshape(batch + (3,)), uv.reshape(batch + (2,)), mat.reshape(batch))


def bvh_trace_anyhit_plain(node_rows, geom_rows, o, d, t_max, work=None):
    """Plain version of kernel 11: True where a row is hit at t < t_max.
    ``work`` as in the closest-hit version; a ray stops counting at its
    first hit."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    tm = t_max.reshape(-1)
    occ = torch.zeros(tm.shape, dtype=torch.bool, device=tm.device)

    def on_leaf_row(ids, rows_idx):
        row = geom_rows[rows_idx]
        t, u, _, det = ray_triangle_edges(of[ids], df[ids], row[:, 0:3], row[:, 3:6],
                                          row[:, 6:9])
        _count_fronts(work, ids, u, det)
        hit = t < tm[ids]
        occ[ids[hit]] = True
        return hit

    _walk(node_rows, of, df, tm, (tm > 0.0).nonzero()[:, 0], work, on_leaf_row)
    return occ.reshape(batch)


def bvh_trace_surface(node_rows, geom_rows, o, d, work=None) -> dict:
    """Closest hit of rays o/d [..., 3] through the [N, 16] nodes over the
    [T', 28] rows, with the winner's attributes: {t, hit, normal, uv,
    mat_id, tri} over o's batch shape, as the JAX package returns them
    (t = +inf, tri = -1 and zeros on a miss). CPU tensors run the plain
    version; CUDA tensors launch kernel 10. ``work`` [R, 2] int32
    (optional) receives each ray's box and triangle tests, from the
    kernel's counting variant on the card."""
    cuda_lib.check_walk_inputs("bvh_trace_surface", node_rows, 16, geom_rows, o, d)
    if o.device.type == "cpu":
        t, tri, _, _, normal, uv, mat = bvh_trace_surface_plain(node_rows, geom_rows, o, d, work)
        return cuda_lib.surface_dict(t, tri, normal, uv, mat)
    outs = cuda_lib.surface_outputs(o.shape[:-1], o.device)
    cuda_lib.launch_walk("strolle_bvh_trace_surface", _aligned(node_rows, geom_rows), o, d, None,
                         outs, work)
    cuda_lib.count_launch("bvh_trace_surface")
    return cuda_lib.surface_dict(*outs)


def bvh_trace_anyhit(node_rows, geom_rows, o, d, t_max, work=None) -> torch.Tensor:
    """Occlusion flag of rays o/d [..., 3] through the BVH: True where a
    triangle is hit at t < t_max. CPU tensors run the plain version; CUDA
    tensors launch kernel 11. ``work`` as in ``bvh_trace_surface``."""
    cuda_lib.check_walk_inputs("bvh_trace_anyhit", node_rows, 16, geom_rows, o, d)
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                            o.shape[:-1]).contiguous()
    if o.device.type == "cpu":
        return bvh_trace_anyhit_plain(node_rows, geom_rows, o, d, tm, work)
    occ = torch.empty(o.shape[:-1], dtype=torch.bool, device=o.device)
    cuda_lib.launch_walk("strolle_bvh_trace_anyhit", _aligned(node_rows, geom_rows), o, d, tm,
                         (occ,), work)
    cuda_lib.count_launch("bvh_trace_anyhit")
    return occ
