"""BVH traversal in plain PyTorch (port of strolle_tpu/bvh/traverse.py).

Mirrors the reference's iterative stack traversal (strolle-gpu/src/
ray.rs:114-266): each ray keeps its own stack of ``bvh.max_depth`` node
ids (the root pre-pushed), pops a node, slab-tests both children against
its best t, intersects leaf children's triangle ranges inline (child 0,
then child 1), and pushes interior children far first, so that the near
one (the smaller entry distance, ties to child 0) pops first. Pushes
write at ``min(ptr, max_depth - 1)``, as the JAX package's do.

The rays advance in lockstep; each step works on the rays whose stacks
are not empty yet, so a finished ray costs nothing. It runs on any
device, outside any kernel, as the JAX package's runs outside Pallas: on
the card it is the closest-hit route of the non-stream strategies
(``ops.trace.trace_closest``) and the route of scenes too big for the
BVH kernels.
"""

from __future__ import annotations

import torch

from ..ops.hit import TriangleHit
from ..ops.intersect import ray_aabb, ray_triangle, safe_inv_dir
from .builder import MAX_LEAF_SIZE

#: Bytes charged per traversal event, matching the reference's
#: used_memory accounting (ray.rs:141,147,184): each visited node
#: fetches its header Vec4 (16 B) + 3 more Vec4s when internal (48 B);
#: each tested leaf triangle fetches one leaf Vec4 + a 9-Vec4 Triangle.
NODE_BYTES = 64
TRIANGLE_BYTES = 160


def _traverse(bvh, positions, o, d, t_limit, any_hit: bool):
    """The traversal of flattened rays o/d [R, 3]. Returns (t, tri, u, v,
    used): the closest hit before ``t_limit`` [R] (tri = -1 and t =
    t_limit where there is none), and the bytes each ray's walk fetched
    (the reference's used_memory). With ``any_hit`` a ray stops after the
    node in which it found its first hit."""
    r = o.shape[0]
    dev = o.device
    maxd = bvh.max_depth
    n_tris = positions.shape[0]
    inv_d = safe_inv_dir(d)
    stack = torch.zeros((r, maxd), dtype=torch.int64, device=dev)
    ptr = torch.ones(r, dtype=torch.int64, device=dev)  # root pre-pushed at slot 0
    best_t = t_limit.to(torch.float32).clone()
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    used = torch.zeros(r, dtype=torch.int32, device=dev)
    live = torch.arange(r, device=dev)
    while live.numel():
        p = ptr[live] - 1
        node = stack[live, torch.clamp(p, max=maxd - 1)]
        used[live] += NODE_BYTES
        lo = bvh.child_min[node]  # [L, 2, 3]
        hi = bvh.child_max[node]
        child = bvh.child[node].long()  # [L, 2]
        count = bvh.child_count[node].long()
        o_l = o[live]
        d_l = d[live]
        tbox = ray_aabb(o_l[:, None], inv_d[live][:, None], lo, hi, best_t[live][:, None])
        box_hit = torch.isfinite(tbox)
        is_leaf = child < 0

        # leaf children: their triangle ranges, child 0 then child 1
        for k in range(2):
            leaf = (box_hit[:, k] & is_leaf[:, k]).nonzero()[:, 0]
            if leaf.numel() == 0:
                continue
            first = -(child[leaf, k] + 1)
            cnt = count[leaf, k]
            used[live[leaf]] += (cnt * TRIANGLE_BYTES).to(torch.int32)
            for j in range(MAX_LEAF_SIZE):
                sel = (j < cnt).nonzero()[:, 0]
                if sel.numel() == 0:
                    break
                ids = live[leaf[sel]]
                tri = torch.clamp(first[sel] + j, 0, n_tris - 1)
                v = positions[tri]
                t, u, w, _ = ray_triangle(o[ids], d[ids], v[:, 0], v[:, 1], v[:, 2])
                better = t < best_t[ids]
                won = ids[better]
                best_t[won] = t[better]
                best_tri[won] = tri[better].to(torch.int32)
                best_u[won] = u[better]
                best_v[won] = w[better]

        # interior children: far pushed first, so the near one pops first
        push = box_hit & ~is_leaf
        far = (tbox[:, 0] <= tbox[:, 1]).long()[:, None]  # child 1 is far when 0 is near
        for k in (far, 1 - far):
            go = push.gather(1, k)[:, 0]
            rows = go.nonzero()[:, 0]
            stack[live[rows], torch.clamp(p[rows], max=maxd - 1)] = child.gather(1, k)[rows, 0]
            p = p + go.long()
        if any_hit:
            p = torch.where(best_tri[live] >= 0, 0, p)
        ptr[live] = p
        live = live[p > 0]
    return best_t, best_tri, best_u, best_v, used


def _flat(o, d):
    return o.reshape(-1, 3), d.reshape(-1, 3)


def trace_closest_bvh(scene, o: torch.Tensor, d: torch.Tensor) -> TriangleHit:
    """Closest hit of rays o/d [..., 3] through the scene's BVH."""
    batch = o.shape[:-1]
    of, df = _flat(o, d)
    inf = torch.full(of.shape[:1], torch.inf, dtype=torch.float32, device=o.device)
    t, tri, u, v, _ = _traverse(scene.bvh, scene.geometry.positions, of, df, inf, any_hit=False)
    return TriangleHit(t=t.reshape(batch), tri=tri.reshape(batch), u=u.reshape(batch),
                       v=v.reshape(batch))


def trace_anyhit_bvh(scene, o: torch.Tensor, d: torch.Tensor, t_max) -> torch.Tensor:
    """Occlusion flag of rays o/d [..., 3]: a triangle hit before t_max."""
    batch = o.shape[:-1]
    of, df = _flat(o, d)
    tl = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                            batch).reshape(-1)
    _, tri, _, _, _ = _traverse(scene.bvh, scene.geometry.positions, of, df, tl, any_hit=True)
    return (tri >= 0).reshape(batch)


def trace_cost_bvh(scene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-ray traversal memory traffic in bytes (the reference's
    used_memory counter, ray.rs:126-147,184) of the closest-hit walk."""
    batch = o.shape[:-1]
    of, df = _flat(o, d)
    inf = torch.full(of.shape[:1], torch.inf, dtype=torch.float32, device=o.device)
    return _traverse(scene.bvh, scene.geometry.positions, of, df, inf, any_hit=False)[4].reshape(
        batch)
