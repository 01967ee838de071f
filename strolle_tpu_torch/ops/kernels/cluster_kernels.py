"""Cluster-culled closest hit and any hit over BVH-ordered clusters (port
of strolle_tpu/ops/pallas/cluster_kernels.py: ``cluster_trace_surface_pallas``
and ``cluster_trace_anyhit_pallas``, with the cluster host code and the
warp walk that the stream kernels share).

Geometry in BVH order is cut into clusters of CLUSTER_TRIS consecutive
triangles, each with its box ([K, 8] rows: bmin(3) bmax(3) first count).
Closest hit (kernel 8) keeps the least (t, row) over the rows of the
clusters a ray enters, from t = +inf (so among exact ties the lowest row
wins in any order), then resolves the winner's normal, uv and material
id from its row; any hit (kernel 9) tests against t_max (no scene-box
clip), stops at its first hit, and a ray with t_max <= 0 never
occludes. A ray with a zero direction walks nothing.

The walk goes by warps of TILE_RAYS consecutive rays of the flat order,
front to back, as the CUDA kernels (``csrc/cluster_kernels.cu``) walk:
each warp's list holds the clusters that any of its live rays enters
before its starting bound (+inf or t_max), keyed by the least entry
distance among them and sorted by (key, cluster) (``warp_lists``); a
warp that enters more than its list cap walks all of them in index order
instead (the overflow path). Before each list entry the warp stops once
the key is past the largest bound of its rays still walking (kernel 8:
best t times TIE_REACH; kernel 9: t_max). Each walking ray re-tests the
cluster's box against its own bound and, when it enters, tests the
cluster's rows [first, min(first + count, T')) in blocks of STAGE_ROWS
(the TPU kernel reads zero-padded whole clusters instead; a zero row
never hits). The TPU kernel enters a cluster when any ray of its 64x128
tile can hit it; both give the same closest hit: a cluster a ray skips
holds no triangle nearer than the ray's best t. The
CUDA kernels test a cluster that few rays of a warp entered across the
warp's lanes, with the same results and counts. Each wrapper below runs
its plain PyTorch version for CPU tensors and launches the kernel for
CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from ..intersect import front_passes, ray_triangle_edges, safe_inv_dir, slab
from . import cuda_lib
from .trace_kernels import resolve_winner

#: Triangles per cluster (a uniform partition of the BVH-ordered rows).
CLUSTER_TRIS = 256
#: Dynamic shared memory of one block on the H100 (227 KB): the wrappers
#: of kernels 8 and 9 take the tables that fit there whole, 7,264
#: clusters (a table that does not fit beside the warps' lists is read
#: from global memory).
MAX_SMEM_BYTES = 227 * 1024
#: Rays walked together: a warp of the CUDA kernels.
TILE_RAYS = 32
#: Most clusters in a warp's list; a warp that enters more walks all K
#: in index order (the JAX package's overflow tiles, ``_list_cap``).
LIST_CAP = 256
#: Rows tested together: the block a warp stages in shared memory.
STAGE_ROWS = 32
#: Kernel 8's box tests take best t times this: a slab's t_near can round
#: a few ulps past the t of a triangle on the box face the ray enters by
#: (3 at most on the dungeon's rows twice over), and the cluster of the
#: lower row of an exact tie must still be entered for that row to win.
TIE_REACH = 1.0 + 2.0**-18


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


def by_warp(x: torch.Tensor, fill) -> torch.Tensor:
    """[R, ...] per ray -> [W, TILE_RAYS, ...], the last warp padded."""
    pad = (-x.shape[0]) % TILE_RAYS
    if pad:
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
    return x.reshape(-1, TILE_RAYS, *x.shape[1:])


def live_rays(d, bound) -> torch.Tensor:
    """The rays that walk: a positive bound and a non-zero direction."""
    return (bound > 0.0) & (d != 0.0).any(dim=-1)


def warp_lists(clus_rows, o, d, bound):
    """Each warp's front-to-back cluster list. A cluster is on it when a
    live ray of the warp enters its box before the ray's ``bound``; its key
    is the least entry distance of those rays. Returns (ids [W, K]: the
    clusters sorted by (key, id), the entered ones first; keys [W, K] in
    that order, +inf past the entered ones; count [W] of entered)."""
    inside, tn = slab(clus_rows[:, 0:3], clus_rows[:, 3:6], o[:, None], safe_inv_dir(d)[:, None],
                      bound[:, None])
    inside &= live_rays(d, bound)[:, None]
    key = by_warp(torch.where(inside, tn, math.inf), math.inf).amin(dim=1)
    keys, ids = torch.sort(key, dim=1, stable=True)
    return ids, keys, by_warp(inside, False).any(dim=1).sum(dim=1)


def warp_steps(best, walking, ids, keys, count, list_cap, reach: float = 1.0):
    """The walk's steps, shared by the plain versions of kernels 5, 6, 8
    and 9: yields (step, the rays whose warp walks this step, the cluster
    each takes). ``best`` [R] and ``walking`` [R] are read afresh each
    step (the caller updates them): a warp stops once its list's key is
    past the largest best t (times ``reach``) of its rays still walking,
    or, overflowing (more than ``list_cap`` entered), once none walks."""
    n_clusters = ids.shape[1]
    overflow = count > list_cap
    steps = torch.where(overflow, n_clusters, count)
    warp = torch.arange(best.shape[0], device=best.device) // TILE_RAYS
    on = steps > 0
    for step in range(int(steps.max()) if steps.numel() else 0):
        mx = by_warp(torch.where(walking, best * reach, -math.inf), -math.inf).amax(dim=1)
        on &= (step < steps) & (mx > -math.inf) & (overflow | (keys[:, step] <= mx))
        if not bool(on.any()):
            break
        k_warp = torch.where(overflow, step, ids[:, step])
        rays = (walking & on[warp]).nonzero()[:, 0]
        yield rays, k_warp[warp[rays]]


def row_hits(geom_rows, o, d, first, last):
    """Möller-Trumbore of each ray against the STAGE_ROWS rows from its
    ``first`` row: (t [n, STAGE_ROWS], +inf from row ``last`` on; u; v; the
    count of rows each ray tests; the tested rows whose first half of the
    test passes, ``front_passes``)."""
    j = first[:, None] + torch.arange(STAGE_ROWS, device=first.device)
    valid = j < torch.as_tensor(last, device=first.device).reshape(-1, 1)
    r = geom_rows[:, 0:9][j.clamp(max=geom_rows.shape[0] - 1)]
    t, u, v, det = ray_triangle_edges(o[:, None], d[:, None], r[..., 0:3], r[..., 3:6],
                                      r[..., 6:9])
    return (torch.where(valid, t, math.inf), u, v, valid.sum(dim=-1, dtype=torch.int32),
            valid & front_passes(u, det))


def count_tests(work, ids, tested, front) -> None:
    """Adds rays ``ids``' ``tested`` [n] triangle tests to ``work`` [R, 2]
    or [R, 3]; a third column also takes the tests whose first half
    passes, ``front`` [n, ...] summed."""
    if work is None:
        return
    work[ids, 1] += tested.to(torch.int32)
    if work.shape[1] > 2:
        work[ids, 2] += front.reshape(front.shape[0], -1).sum(dim=-1, dtype=torch.int32)


def keep_closest(hits, ids, first, best, btri, bu, bv):
    """Keeps, for rays ``ids``, the least (t, row) of ``row_hits``' output
    where it is below (best t, best row): among exact ties the lowest row
    wins in whatever order blocks come, and a hit at exactly a best t
    with no hit yet (the scene-box cap of kernel 5, +inf) stays a miss."""
    t, u, v = hits[:3]
    j = torch.argmin(t, dim=-1, keepdim=True)
    tj = t.gather(-1, j)[:, 0]
    row = (first + j[:, 0]).to(torch.int32)
    bt, bi = best[ids], btri[ids]
    better = (tj < bt) | ((tj == bt) & (bi >= 0) & (row < bi))
    w = ids[better]
    best[w] = tj[better]
    btri[w] = row[better]
    bu[w] = u.gather(-1, j)[better, 0]
    bv[w] = v.gather(-1, j)[better, 0]


def first_hits(hits, ids, t_max, occ, walking, work):
    """Marks rays ``ids`` occluded where a row of ``row_hits``' output is
    hit before their ``t_max`` and takes them out of ``walking``; ``work``
    (optional) counts each ray's rows up to its first hit (``count_tests``)."""
    t, _, _, n, front = hits
    hit = t < t_max[ids, None]
    any_hit = hit.any(dim=-1)
    if work is not None:
        tested = torch.where(any_hit, hit.to(torch.int32).argmax(dim=-1) + 1, n)
        upto = torch.arange(t.shape[1], device=t.device) < tested[:, None]
        count_tests(work, ids, tested, front & upto)
    done = ids[any_hit]
    occ[done] = True
    walking[done] = False


def _walk(clus_rows, geom_rows, o, d, best, walking, work, on_rows, list_cap, reach=1.0):
    """The warp walk both plain versions share. ``best`` [R] times
    ``reach`` is the slab tests' bound, ``best`` updated in place by
    ``on_rows(ids, first, last)`` (the rays that entered a cluster, the
    first row of their block of STAGE_ROWS and the cluster's end), which
    also clears ``walking`` [R] (the live rays) for rays that leave the
    walk. ``work`` [R, 2] or [R, 3] (optional) counts box tests and
    triangle tests (``count_tests``)."""
    inv = safe_inv_dir(d)
    ids, keys, count = warp_lists(clus_rows, o, d, best * reach)
    if work is not None:
        work[walking, 0] += clus_rows.shape[0]
    firsts = clus_rows[:, 6].to(torch.int64)
    lasts = torch.clamp(firsts + clus_rows[:, 7].to(torch.int64), max=geom_rows.shape[0])
    for rays, k in warp_steps(best, walking, ids, keys, count, list_cap, reach):
        if work is not None:
            work[rays, 0] += 1
        box = clus_rows[k]
        inside = slab(box[:, 0:3], box[:, 3:6], o[rays], inv[rays], best[rays] * reach)[0]
        rays, first, last = rays[inside], firsts[k[inside]], lasts[k[inside]]
        while True:
            keep = walking[rays] & (first < last)
            rays, first, last = rays[keep], first[keep], last[keep]
            if rays.numel() == 0:
                break
            on_rows(rays, first, last)
            first = first + STAGE_ROWS


def cluster_trace_surface_plain(clus_rows, geom_rows, o, d, work=None, list_cap=LIST_CAP):
    """Plain version of kernel 8: (t, tri, u, v, normal, uv, mat_id) over
    o's batch shape; t = +inf, tri = -1 and zeros on a miss. ``work``
    [R, 2] int32 (optional) accumulates each ray's box and triangle
    tests; [R, 3] also the tests whose first half passes (``front_passes``)."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    r = of.shape[0]
    best = torch.full((r,), math.inf, dtype=torch.float32, device=o.device)
    btri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)

    def on_rows(ids, first, last):
        hits = row_hits(geom_rows, of[ids], df[ids], first, last)
        count_tests(work, ids, hits[3], hits[4])
        keep_closest(hits, ids, first, best, btri, bu, bv)

    _walk(clus_rows, geom_rows, of, df, best, live_rays(df, best), work, on_rows, list_cap,
          TIE_REACH)
    normal, uv, mat = resolve_winner(geom_rows, df, btri, bu, bv)
    return (best.reshape(batch), btri.reshape(batch), bu.reshape(batch), bv.reshape(batch),
            normal.reshape(batch + (3,)), uv.reshape(batch + (2,)), mat.reshape(batch))


def cluster_trace_anyhit_plain(clus_rows, geom_rows, o, d, t_max, work=None, list_cap=LIST_CAP):
    """Plain version of kernel 9: True where a row is hit at t < t_max.
    ``work`` as in the closest-hit version; a ray stops counting at its
    first hit."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    tm = t_max.reshape(-1)
    occ = torch.zeros(tm.shape, dtype=torch.bool, device=tm.device)
    walking = live_rays(df, tm)

    def on_rows(ids, first, last):
        first_hits(row_hits(geom_rows, of[ids], df[ids], first, last), ids, tm, occ, walking,
                   work)

    _walk(clus_rows, geom_rows, of, df, tm, walking, work, on_rows, list_cap)
    return occ.reshape(batch)


def check_clusters(name, clus_rows, geom_rows, o, d):
    """The inputs of a cluster-walking wrapper (kernels 5, 6, 8, 9):
    [K, 8] cluster rows whose K*CLUSTER_TRIS rows cover the [T', 28] rows."""
    cuda_lib.check_walk_inputs(name, clus_rows, 8, geom_rows, o, d)
    if geom_rows.shape[0] > clus_rows.shape[0] * CLUSTER_TRIS:
        raise ValueError(f"{name}: {geom_rows.shape[0]} rows > {clus_rows.shape[0]} clusters")


def _check_cluster_kernel(name, clus_rows, geom_rows, o, d):
    """``check_clusters``, and a table of at most MAX_SMEM_BYTES: the range
    that kernels 8 and 9 have always taken."""
    check_clusters(name, clus_rows, geom_rows, o, d)
    if clus_rows.numel() * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {clus_rows.shape[0]} cluster rows exceed the "
                         f"{MAX_SMEM_BYTES} bytes of shared memory per block")


def launch_head(clus_rows, geom_rows, list_cap: int = LIST_CAP) -> tuple:
    """The arguments kernels 8 and 9 take before the rays (the rows must
    lie on a 16-byte boundary: the kernels stage them in 16-byte loads)."""
    return (clus_rows, clus_rows.shape[0], list_cap, geom_rows, geom_rows.shape[0])


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
