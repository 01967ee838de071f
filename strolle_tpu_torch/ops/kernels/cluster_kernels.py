"""Cluster-culled closest hit and any hit over BVH-ordered clusters (port
of strolle_tpu/ops/pallas/cluster_kernels.py: ``cluster_trace_surface_pallas``
and ``cluster_trace_anyhit_pallas``, with the cluster host code that the
stream kernels share).

Geometry in BVH order is cut into clusters of CLUSTER_TRIS consecutive
triangles, each with its box ([K, 8] rows: bmin(3) bmax(3) first count).
A ray walks the clusters in index order: it slab-tests a cluster's box
against its current best t and, when it enters, runs Möller-Trumbore
over the cluster's ``count`` rows, keeping a hit on strict ``<`` (ties go
to the lowest row). Closest hit (kernel 8) starts at t = +inf and then
resolves the winner's normal, uv and material id from its row; any hit
(kernel 9) tests against t_max (no scene-box clip), stops at its first
hit, and a ray with t_max <= 0 never occludes.

The TPU kernel enters a cluster when any ray of its 64x128 tile can hit
it; here each ray decides for itself. Both give the same closest hit: a
cluster a ray skips holds no triangle nearer than the ray's best t. The
CUDA kernels (``csrc/cluster_kernels.cu``) run one thread per ray; each
wrapper below runs its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from ..intersect import ray_triangle_edges, safe_inv_dir, slab
from . import cuda_lib
from .trace_kernels import resolve_winner

#: Triangles per cluster (a uniform partition of the BVH-ordered rows).
CLUSTER_TRIS = 256
#: Dynamic shared memory of one block on the H100 (227 KB), where
#: kernels 8 and 9 stage the cluster rows: 7,264 clusters.
MAX_SMEM_BYTES = 227 * 1024
#: Rows per vectorised step of the plain versions.
PLAIN_ROWS = 64


def num_clusters(num_tris: int) -> int:
    return -(-max(num_tris, 1) // CLUSTER_TRIS)


def clusterize_bvh(bvh, num_tris: int, positions: torch.Tensor | None = None) -> torch.Tensor:
    """Geometry in BVH order -> [K, 8] rows: bmin(3) bmax(3) first count.

    Cluster k covers rows [k*CLUSTER_TRIS, (k+1)*CLUSTER_TRIS); the rows
    past the last triangle replicate it, so the last box stays tight.
    ``positions`` [T, 3, 3] are required: the JAX package's fallback to
    the BVH's leaf boxes is not ported."""
    if positions is None:
        raise NotImplementedError(
            "clusterize_bvh from the BVH's leaf boxes alone is not ported; pass positions"
        )
    k = num_clusters(num_tris)
    t = positions.shape[0]
    v = positions.reshape(t, 9)
    pad = k * CLUSTER_TRIS - t
    if pad:
        v = torch.cat([v, v[-1:].expand(pad, 9)])
    v = v.reshape(k, CLUSTER_TRIS, 3, 3)
    firsts = torch.arange(k, dtype=torch.int32, device=positions.device) * CLUSTER_TRIS
    counts = torch.clamp(num_tris - firsts, max=CLUSTER_TRIS)
    return torch.cat(
        [
            v.amin(dim=(1, 2)),
            v.amax(dim=(1, 2)),
            firsts.to(torch.float32)[:, None],
            counts.to(torch.float32)[:, None],
        ],
        dim=-1,
    )


def _walk(clus_rows, geom_rows, of, df, best, live, work, on_rows):
    """The index-order cluster walk both plain versions share: an entered
    cluster's rows [first, min(first + count, T')), as the kernels clamp
    them (the TPU kernel reads zero-padded whole clusters instead; a zero
    row never hits). ``best`` [R] bounds the slab tests; ``live`` holds the rays still walking.
    ``on_rows(ids, first, rows)`` tests rays ``ids`` against a block of
    an entered cluster's rows and returns the rays that leave the walk
    (or None). ``work`` [R, 2] (optional) counts box and triangle tests."""
    inv = safe_inv_dir(df)
    spans = clus_rows[:, 6:8].to(torch.int64).tolist()
    for k, (first, count) in enumerate(spans):
        if live.numel() == 0:
            break
        if work is not None:
            work[live, 0] += 1
        box = clus_rows[k]
        ids = live[slab(box[0:3], box[3:6], of[live], inv[live], best[live])[0]]
        last = min(first + count, geom_rows.shape[0])
        for r0 in range(first, last, PLAIN_ROWS):
            if ids.numel() == 0:
                break
            done = on_rows(ids, r0, geom_rows[r0 : min(r0 + PLAIN_ROWS, last)])
            if done is not None and done.numel():
                ids = ids[~torch.isin(ids, done)]
                live = live[~torch.isin(live, done)]


def cluster_trace_surface_plain(clus_rows, geom_rows, o, d, work=None):
    """Plain version of kernel 8: (t, tri, u, v, normal, uv, mat_id) over
    o's batch shape; t = +inf, tri = -1 and zeros on a miss. ``work``
    [R, 2] int32 (optional) accumulates each ray's box and triangle
    tests."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    r = of.shape[0]
    best = torch.full((r,), math.inf, dtype=torch.float32, device=o.device)
    btri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)

    def on_rows(ids, first, rows):
        if work is not None:
            work[ids, 1] += rows.shape[0]
        t, u, v, _ = ray_triangle_edges(
            of[ids, None], df[ids, None], rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        )
        j = torch.argmin(t, dim=-1, keepdim=True)
        tj = t.gather(-1, j)[:, 0]
        better = tj < best[ids]
        w = ids[better]
        best[w] = tj[better]
        btri[w] = (first + j[better, 0]).to(torch.int32)
        bu[w] = u.gather(-1, j)[better, 0]
        bv[w] = v.gather(-1, j)[better, 0]
        return None

    _walk(clus_rows, geom_rows, of, df, best, torch.arange(r, device=o.device), work, on_rows)
    normal, uv, mat = resolve_winner(geom_rows, df, btri, bu, bv)
    return (best.reshape(batch), btri.reshape(batch), bu.reshape(batch), bv.reshape(batch),
            normal.reshape(batch + (3,)), uv.reshape(batch + (2,)), mat.reshape(batch))


def cluster_trace_anyhit_plain(clus_rows, geom_rows, o, d, t_max, work=None):
    """Plain version of kernel 9: True where a row is hit at t < t_max.
    ``work`` as in the closest-hit version; a ray stops counting at its
    first hit."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    tm = t_max.reshape(-1)
    occ = torch.zeros(tm.shape, dtype=torch.bool, device=tm.device)

    def on_rows(ids, first, rows):
        t = ray_triangle_edges(
            of[ids, None], df[ids, None], rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        )[0]
        hit = t < tm[ids, None]
        any_hit = hit.any(dim=-1)
        if work is not None:
            tested = torch.where(any_hit, hit.to(torch.int32).argmax(dim=-1) + 1, rows.shape[0])
            work[ids, 1] += tested.to(torch.int32)
        done = ids[any_hit]
        occ[done] = True
        return done

    _walk(clus_rows, geom_rows, of, df, tm, (tm > 0.0).nonzero()[:, 0], work, on_rows)
    return occ.reshape(batch)


def check_clusters(name, clus_rows, geom_rows, o, d):
    """The inputs of a cluster-walking wrapper (kernels 5, 6, 8, 9):
    [K, 8] cluster rows whose K*CLUSTER_TRIS rows cover the [T', 28] rows."""
    cuda_lib.check_walk_inputs(name, clus_rows, 8, geom_rows, o, d)
    if geom_rows.shape[0] > clus_rows.shape[0] * CLUSTER_TRIS:
        raise ValueError(f"{name}: {geom_rows.shape[0]} rows > {clus_rows.shape[0]} clusters")


def _check_cluster_kernel(name, clus_rows, geom_rows, o, d):
    """``check_clusters``, and a table that fits the shared memory kernels
    8 and 9 stage it in."""
    check_clusters(name, clus_rows, geom_rows, o, d)
    if clus_rows.numel() * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {clus_rows.shape[0]} cluster rows exceed the "
                         f"{MAX_SMEM_BYTES} bytes of shared memory per block")


def launch_head(clus_rows, geom_rows) -> tuple:
    """The arguments kernels 8 and 9 take before the rays."""
    return (clus_rows, clus_rows.shape[0], geom_rows, geom_rows.shape[0])


def cluster_trace_surface(clus_rows, geom_rows, o, d, work=None) -> dict:
    """Closest hit of rays o/d [..., 3] over the clustered [T', 28] rows
    with the winner's attributes: {t, hit, normal, uv, mat_id, tri} over
    o's batch shape, as the JAX package returns them (t = +inf, tri = -1
    and zeros on a miss). CPU tensors run the plain version; CUDA tensors
    launch kernel 8. ``work`` [R, 2] int32 (optional) receives each ray's
    box and triangle tests, from the kernel's counting variant on the
    card."""
    _check_cluster_kernel("cluster_trace_surface", clus_rows, geom_rows, o, d)
    if o.device.type == "cpu":
        t, tri, _, _, normal, uv, mat = cluster_trace_surface_plain(clus_rows, geom_rows, o, d,
                                                                    work)
        return cuda_lib.surface_dict(t, tri, normal, uv, mat)
    outs = cuda_lib.surface_outputs(o.shape[:-1], o.device)
    cuda_lib.launch_walk("strolle_cluster_trace_surface", launch_head(clus_rows, geom_rows), o,
                         d, None, outs, work)
    cuda_lib.count_launch("cluster_trace_surface")
    return cuda_lib.surface_dict(*outs)


def cluster_trace_anyhit(clus_rows, geom_rows, o, d, t_max, work=None) -> torch.Tensor:
    """Occlusion flag of rays o/d [..., 3] over the clustered rows: True
    where a triangle is hit at t < t_max. CPU tensors run the plain
    version; CUDA tensors launch kernel 9. ``work`` as in
    ``cluster_trace_surface``."""
    _check_cluster_kernel("cluster_trace_anyhit", clus_rows, geom_rows, o, d)
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                            o.shape[:-1]).contiguous()
    if o.device.type == "cpu":
        return cluster_trace_anyhit_plain(clus_rows, geom_rows, o, d, tm, work)
    occ = torch.empty(o.shape[:-1], dtype=torch.bool, device=o.device)
    cuda_lib.launch_walk("strolle_cluster_trace_anyhit", launch_head(clus_rows, geom_rows), o, d,
                         tm, (occ,), work)
    cuda_lib.count_launch("cluster_trace_anyhit")
    return occ
