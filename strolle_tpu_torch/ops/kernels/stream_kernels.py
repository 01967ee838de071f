"""Big-scene closest-hit and any-hit over BVH-ordered clusters (port of
strolle_tpu/ops/pallas/stream_kernels.py: ``stream_trace_surface_pallas``
and ``stream_trace_anyhit_pallas``; the cluster rows come from
cluster_kernels.py, as the JAX package's do).

Geometry in BVH order is cut into clusters of CLUSTER_TRIS consecutive
triangles, each cut again into SUB sub-blocks of SUB_TRIS. Closest hit
(kernel 5) starts its best t at the ray's exit from the scene box
(``scene_tcap``); any-hit (kernel 6) tests against ``min(t_max,
scene_tcap)`` and stops at its first hit. Rays that miss the scene box,
zero-length rays and rays with nothing left to test leave at once.

The walk goes by warps of TILE_RAYS consecutive rays of the flat order,
front to back, as the CUDA kernels (``csrc/stream_kernels.cu``) walk:
each warp's list holds the clusters that any of its live rays enters
before its starting bound, keyed by the least entry distance among them
and sorted by (key, cluster) (``warp_lists``); a warp that enters more
than LIST_CAP clusters walks all of them in index order instead. Before
each list entry the warp stops once the key is past the largest best t
of its rays still walking. Each walking ray re-tests the cluster's box
against its own best t, then its sub-block boxes in turn, and runs
Möller-Trumbore over the rows of each sub-block it enters. Closest hit
keeps a hit on (t, row) < (best t, best row), so among exact ties the
lowest row wins in any walk order, and a hit at exactly the cap stays a
miss. The TPU kernels build their lists per (32, 128) ray tile outside
the kernel; the walk is the same in kind. The CUDA kernels test a
sub-block that few rays of a warp entered across the warp's lanes, with
the same results and counts. Each wrapper below runs its plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..intersect import safe_inv_dir, slab
from . import cuda_lib
from .cluster_kernels import (
    CLUSTER_TRIS, LIST_CAP, STAGE_ROWS, check_clusters, count_tests, first_hits, keep_closest,
    live_rays, row_hits, warp_lists, warp_steps,
)
from .cluster_kernels import TILE_RAYS, clusterize_bvh, num_clusters  # noqa: F401

#: Sub-blocks per cluster, and triangles per sub-block (a staged block).
SUB = 8
SUB_TRIS = CLUSTER_TRIS // SUB
assert SUB_TRIS == STAGE_ROWS
#: The scene-box cap's scale and offset, as the float32 values the JAX
#: package multiplies and adds.
_CAP_SCALE = float(np.float32(1.0001))
_CAP_OFFSET = float(np.float32(1e-4))


def sub_aabbs(clus_rows: torch.Tensor, geom_rows: torch.Tensor) -> torch.Tensor:
    """[K*SUB, 8] sub-block boxes (lo3 hi3 pad2) of the [T', 28] rows.
    Rows past T' replicate the last row's box, as the JAX package does."""
    k = clus_rows.shape[0]
    need = k * CLUSTER_TRIS
    v0 = geom_rows[:, 0:3]
    p1 = v0 + geom_rows[:, 3:6]
    p2 = v0 + geom_rows[:, 6:9]
    lo = torch.minimum(v0, torch.minimum(p1, p2))
    hi = torch.maximum(v0, torch.maximum(p1, p2))
    t = geom_rows.shape[0]
    if t < need:
        lo = torch.cat([lo, lo[-1:].expand(need - t, 3)])
        hi = torch.cat([hi, hi[-1:].expand(need - t, 3)])
    lo = lo[:need].reshape(k * SUB, SUB_TRIS, 3).amin(dim=1)
    hi = hi[:need].reshape(k * SUB, SUB_TRIS, 3).amax(dim=1)
    return torch.cat([lo, hi, lo.new_zeros((k * SUB, 2))], dim=-1)


def scene_tcap(clus_rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Each ray's exit distance from the scene box (the union of the
    cluster boxes) times 1.0001 plus 1e-4, or 0 for a ray that misses it.
    No triangle lies beyond it. The scale and offset round once, as one
    fused multiply-add (formed in float64, as ``intersect.fma``), the way
    XLA compiles the JAX package's."""
    lo = clus_rows[:, 0:3].amin(dim=0)
    hi = clus_rows[:, 3:6].amax(dim=0)
    inv = safe_inv_dir(d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    miss = (tn > tf) | (tf < 0.0)
    return torch.where(miss, 0.0, (tf.double() * _CAP_SCALE + _CAP_OFFSET).float())


def _walk(clus_rows, sub_rows, geom_rows, o, d, best, walking, work, on_subblock, list_cap):
    """The warp walk shared by both plain versions. ``best`` [R] is the
    slab tests' bound, updated in place by ``on_subblock(ids, first)``
    (the rays that entered a sub-block, and its first row per ray), which
    also clears ``walking`` [R] (the live rays) for rays that leave the
    walk. ``work`` [R, 2] or [R, 3] (optional) counts box tests and
    triangle tests (``count_tests``)."""
    inv = safe_inv_dir(d)
    n_rows = geom_rows.shape[0]
    ids, keys, count = warp_lists(clus_rows, o, d, best)
    if work is not None:
        work[walking, 0] += clus_rows.shape[0]
    for rays, k in warp_steps(best, walking, ids, keys, count, list_cap):
        if work is not None:
            work[rays, 0] += 1
        box = clus_rows[k]
        inside = slab(box[:, 0:3], box[:, 3:6], o[rays], inv[rays], best[rays])[0]
        rays, k = rays[inside], k[inside]
        for s in range(SUB):
            keep = walking[rays]
            rays, k = rays[keep], k[keep]
            if rays.numel() == 0:
                break
            if work is not None:
                work[rays, 0] += 1
            sub = sub_rows[k * SUB + s]
            inside = slab(sub[:, 0:3], sub[:, 3:6], o[rays], inv[rays], best[rays])[0]
            first = k[inside] * CLUSTER_TRIS + s * SUB_TRIS
            some = first < n_rows
            if bool(some.any()):
                on_subblock(rays[inside][some], first[some])


def stream_trace_surface_plain(clus_rows, sub_rows, geom_rows, o, d, tcap, work=None,
                               list_cap=LIST_CAP):
    """Plain version of kernel 5: (t, tri, u, v) over o's batch shape.
    t starts at ``tcap`` and stays there on a miss; tri = -1 on a miss.
    ``work`` [R, 2] int32 (optional) accumulates each ray's box tests and
    triangle tests; [R, 3] also the tests whose first half passes
    (``front_passes``)."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    best = tcap.reshape(-1).clone()
    btri = torch.full_like(best, -1, dtype=torch.int32)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)

    def on_subblock(ids, first):
        hits = row_hits(geom_rows, of[ids], df[ids], first, geom_rows.shape[0])
        count_tests(work, ids, hits[3], hits[4])
        keep_closest(hits, ids, first, best, btri, bu, bv)

    _walk(clus_rows, sub_rows, geom_rows, of, df, best, live_rays(df, best), work, on_subblock,
          list_cap)
    return best.reshape(batch), btri.reshape(batch), bu.reshape(batch), bv.reshape(batch)


def stream_trace_anyhit_plain(clus_rows, sub_rows, geom_rows, o, d, t_max, work=None,
                              list_cap=LIST_CAP):
    """Plain version of kernel 6: True where a row is hit at t < t_max.
    ``t_max`` is already clipped to the scene-box exit
    (``clipped_t_max``). ``work`` as in the closest-hit version; a ray
    stops counting at its first hit."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    tm = t_max.reshape(-1)
    occ = torch.zeros(tm.shape, dtype=torch.bool, device=tm.device)
    walking = live_rays(df, tm)

    def on_subblock(ids, first):
        first_hits(row_hits(geom_rows, of[ids], df[ids], first, geom_rows.shape[0]), ids, tm,
                   occ, walking, work)

    _walk(clus_rows, sub_rows, geom_rows, of, df, tm, walking, work, on_subblock, list_cap)
    return occ.reshape(batch)


def clipped_t_max(clus_rows, o, d, t_max) -> torch.Tensor:
    """min(t_max, scene_tcap): no occluder lies past the scene box, and
    a ray that misses the box gets 0, so it tests nothing."""
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                               o.shape[:-1])
    return torch.minimum(t_max, scene_tcap(clus_rows, o, d)).contiguous()


def launch_head(clus_rows, sub_rows, geom_rows, list_cap: int = LIST_CAP) -> tuple:
    """The arguments kernels 5 and 6 take before the rays (the rows must
    lie on a 16-byte boundary: the kernels stage them in 16-byte loads)."""
    return (clus_rows, sub_rows, clus_rows.shape[0], list_cap, geom_rows, geom_rows.shape[0])


def stream_trace_surface(clus_rows, geom_rows, o, d, work=None) -> dict:
    """Closest hit of rays o/d [..., 3] over the clustered [T', 28] rows:
    {t, hit, u, v, tri} over o's batch shape, as the JAX package returns
    them (t is the scene-box cap on a miss; tri = -1 there). CPU tensors
    run the plain version; CUDA tensors launch kernel 5. ``work`` [R, 2]
    int32 (optional) receives each ray's box and triangle tests, from
    the kernel's counting variant on the card."""
    check_clusters("stream_trace_surface", clus_rows, geom_rows, o, d)
    sub_rows = sub_aabbs(clus_rows, geom_rows).contiguous()
    tcap = scene_tcap(clus_rows, o, d).contiguous()
    if o.device.type == "cpu":
        t, tri, u, v = stream_trace_surface_plain(clus_rows, sub_rows, geom_rows, o, d, tcap,
                                                  work)
    else:
        batch = o.shape[:-1]
        t = torch.empty(batch, dtype=torch.float32, device=o.device)
        tri = torch.empty(batch, dtype=torch.int32, device=o.device)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        cuda_lib.launch_walk("strolle_stream_trace_surface",
                             launch_head(clus_rows, sub_rows, geom_rows), o, d, tcap,
                             (t, tri, u, v), work)
        cuda_lib.count_launch("stream_trace_surface")
    hit = tri >= 0
    return {"t": t, "hit": hit, "u": u, "v": v, "tri": torch.where(hit, tri, -1)}


def stream_trace_anyhit(clus_rows, geom_rows, o, d, t_max, work=None) -> torch.Tensor:
    """Occlusion flag of rays o/d [..., 3] over the clustered rows: True
    where a triangle is hit before min(t_max, scene-box exit). CPU tensors
    run the plain version; CUDA tensors launch kernel 6. ``work`` as in
    ``stream_trace_surface``."""
    check_clusters("stream_trace_anyhit", clus_rows, geom_rows, o, d)
    sub_rows = sub_aabbs(clus_rows, geom_rows).contiguous()
    tm = clipped_t_max(clus_rows, o, d, t_max)
    if o.device.type == "cpu":
        return stream_trace_anyhit_plain(clus_rows, sub_rows, geom_rows, o, d, tm, work)
    occ = torch.empty(o.shape[:-1], dtype=torch.bool, device=o.device)
    cuda_lib.launch_walk("strolle_stream_trace_anyhit",
                         launch_head(clus_rows, sub_rows, geom_rows), o, d, tm, (occ,), work)
    cuda_lib.count_launch("stream_trace_anyhit")
    return occ
