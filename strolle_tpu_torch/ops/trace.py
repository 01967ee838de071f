"""Ray tracing entry points, closest hit and any hit (port of
strolle_tpu/ops/trace.py).

Scenes of up to BRUTE_FORCE_MAX_TRIS triangles go through the
brute-force kernels of ops/kernels/trace_kernels.py, and so do bigger
scenes without a BVH, as in the JAX package: kernels A and B over all
rows, and ``trace_surface`` through ``trace_closest`` + ``surface_at``.
Bigger scenes with a BVH (``bvh.scene_with_bvh``) take the route that
BIG_SCENE_STRATEGY selects, as in the JAX package: "stream" (the
default) the stream kernels of ops/kernels/stream_kernels.py; "cluster"
the cluster kernels of ops/kernels/cluster_kernels.py (or the stream
kernels for a scene they do not take); "packet" and "jnp" the BVH
kernels of ops/kernels/bvh_kernels.py where the scene fits them, else
the torch traversal of bvh/traverse.py, which is also their closest-hit
route (``trace_closest``). Each kernel runs CUDA on the card and its plain
version on the CPU. Set the strategy as in the JAX package::

    import strolle_tpu_torch.ops.trace as trace
    trace.BIG_SCENE_STRATEGY = "packet"

A scene with alpha-blended materials (``has_alpha``) takes the JAX
package's restart loop in ``trace_closest`` and ``trace_anyhit``: a hit
whose sampled base-colour alpha is below 1 is skipped by restarting the
ray just past it, MAX_ALPHA_RESTARTS times, each restart one launch of
the opaque closest-hit route above. ``trace_surface`` takes
``trace_closest`` + ``surface_at`` on such a scene, as the fused kernels
have no alpha test.

Inside ``trace_rows_sharded(mesh)`` the three entry points split their
rays' leading (pixel-row) axis over the ranks of a
``torch.distributed`` device mesh, as the JAX package's shard_map does:
each rank traces its own block of rows through the route above (its
kernel) and the blocks are gathered, so every rank returns the whole
result. The split is forward only.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from ..bvh.traverse import trace_anyhit_bvh, trace_closest_bvh
from ..scene.types import Scene
from .hit import NUDGE_OFFSET, Surface, TriangleHit, material_at, surface_at
from .intersect import fma, ray_triangle
from .kernels import bvh_kernels as bk
from .kernels import cluster_kernels as ck
from .kernels import stream_kernels as sk
from .kernels import trace_kernels as tk
from .texture import sample_material_channel

BRUTE_FORCE_MAX_TRIS = tk.MAX_TRIS
#: The big-scene strategy: "stream", "cluster", "packet" or "jnp", as the
#: JAX package names them (strolle_tpu/ops/trace.py BIG_SCENE_STRATEGY).
BIG_SCENE_STRATEGY = "stream"
#: The JAX package's VMEM budget for its cluster and BVH kernels, kept
#: here as a routing rule only: it decides which scenes take kernels 8-11,
#: so that a scene takes the route it takes in the JAX package. It is no
#: limit of the H100, whose kernels read their rows through the
#: read-only path.
_KERNEL_ROUTE_BUDGET = 12 * 2**20


def is_big(scene: Scene) -> bool:
    """Does the scene take a big-scene route (over BRUTE_FORCE_MAX_TRIS
    triangles, with a BVH)? A big scene without one takes kernels A and B."""
    return scene.geometry.num_triangles > BRUTE_FORCE_MAX_TRIS and scene.bvh is not None


def _bvh_kernel_fits(scene: Scene) -> bool:
    n_nodes = scene.bvh.child.shape[0]
    n_rows = scene.geometry.num_triangles
    return (n_nodes * 16 + n_rows * 28) * 4 <= _KERNEL_ROUTE_BUDGET


def _cluster_kernel_fits(scene: Scene) -> bool:
    n_rows = scene.geometry.num_triangles
    return (ck.num_clusters(n_rows) * 8 + n_rows * 28) * 4 <= _KERNEL_ROUTE_BUDGET


def _stream_route(scene: Scene) -> bool:
    """Does a big scene take the stream kernels (5, 6)?"""
    return BIG_SCENE_STRATEGY == "stream" or (
        BIG_SCENE_STRATEGY == "cluster" and not _cluster_kernel_fits(scene)
    )


def cluster_rows(scene: Scene) -> torch.Tensor:
    """The scene's [K, 8] cluster rows: prebuilt by ``bvh.scene_with_bvh``,
    or made here from its BVH-ordered positions."""
    if scene.clusters is not None:
        return scene.clusters.detach()
    return ck.clusterize_bvh(scene.bvh, scene.geometry.num_triangles,
                             scene.geometry.positions.detach())


#: The device mesh the trace entry points split their rays over, set by
#: ``trace_rows_sharded`` (the JAX package's context of the same name).
_TRACE_MESH: contextvars.ContextVar = contextvars.ContextVar("strolle_trace_mesh", default=None)


@contextlib.contextmanager
def trace_rows_sharded(mesh):
    """While active, ``trace_surface``, ``trace_closest`` and
    ``trace_anyhit`` split their ray rows over ``mesh`` (a
    ``torch.distributed`` DeviceMesh that spans the process group) and
    gather the results. ``mesh=None`` is a no-op (one device)."""
    if mesh is None:
        yield
        return
    token = _TRACE_MESH.set(mesh)
    try:
        yield
    finally:
        _TRACE_MESH.reset(token)


def _shard_over_rows(mesh, fn, scene, *rays):
    """``fn(scene, *rays)`` on this rank's contiguous block of the rays'
    leading axis, with the mesh context cleared so that the nested entry
    point takes its single-rank route; every output field gathered along
    dim 0 over the ranks. The leading axis must divide by the mesh size
    (as shard_map requires). Forward only: rays that require grad raise
    here, and outputs that carry a gradient (a scene that requires one)
    raise in the gather."""
    from ..parallel.sharding import gather_rows, mesh_block

    n = mesh.size()
    h = rays[0].shape[0]
    if h % n:
        raise ValueError(f"trace_rows_sharded: {h} rows do not divide over {n} ranks")
    if any(r.requires_grad for r in rays):
        raise ValueError("trace_rows_sharded splits the forward pass only: its rays must not "
                         "require grad (no sharded frame is differentiated)")
    rows = h // n
    i = mesh_block(mesh)
    local = [r[i * rows:(i + 1) * rows] for r in rays]
    token = _TRACE_MESH.set(None)
    try:
        out = fn(scene, *local)
    finally:
        _TRACE_MESH.reset(token)
    return gather_rows(out)


def packed_tri_rows(scene: Scene) -> torch.Tensor:
    """[T', 12] kernel rows, zero-padded to a multiple of 8 like the JAX
    package's (a zero row never hits)."""
    rows = tk.pack_triangles(scene.geometry.positions)
    pad = (-rows.shape[0]) % 8
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, 12))])
    return rows.contiguous()


def packed_geom_rows(scene: Scene) -> torch.Tensor:
    """[T', 28] surface-kernel rows, zero-padded to a multiple of 8."""
    rows = tk.pack_geometry(scene.geometry)
    pad = (-rows.shape[0]) % 8
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, 28))])
    return rows.contiguous()


def trace_closest_brute(scene: Scene, o: torch.Tensor, d: torch.Tensor) -> TriangleHit:
    """Closest hit over all triangles, in plain PyTorch on any device."""
    t, tri, u, v = tk.trace_closest_brute_plain(packed_tri_rows(scene), o, d)
    return TriangleHit(t=t, tri=tri, u=u, v=v)


def trace_anyhit_brute(scene: Scene, o, d, t_max) -> torch.Tensor:
    """Occlusion query in plain PyTorch on any device: True where any
    triangle lies within t_max."""
    return tk.trace_anyhit_brute_plain(packed_tri_rows(scene), o, d, t_max)


def _stream_closest(scene: Scene, o, d) -> dict:
    """Kernel 5 on detached rays."""
    return sk.stream_trace_surface(
        cluster_rows(scene),
        packed_geom_rows(scene).detach(),
        o.detach().contiguous(),
        d.detach().contiguous(),
    )


def _trace_closest_kernel(scene: Scene, o, d) -> TriangleHit:
    """The winning triangle on detached rays (kernel A, or for a big scene
    with a BVH kernel 5 under "stream" and the torch BVH traversal under
    the other strategies); t/u/v are then recomputed through that triangle
    with plain tensor ops, so gradients with respect to rays and vertices
    flow."""
    if is_big(scene):
        if BIG_SCENE_STRATEGY == "stream":
            tri = _stream_closest(scene, o, d)["tri"]
        else:
            tri = trace_closest_bvh(scene, o.detach(), d.detach()).tri
    else:
        rows = packed_tri_rows(scene).detach()
        _, tri, _, _ = tk.trace_closest_brute(
            rows, o.detach().contiguous(), d.detach().contiguous()
        )
    verts = scene.geometry.positions[torch.clamp(tri, min=0).long()]
    t2, u2, v2, _ = ray_triangle(o, d, verts[..., 0, :], verts[..., 1, :], verts[..., 2, :])
    valid = tri >= 0
    return TriangleHit(
        t=torch.where(valid, t2, math.inf),
        tri=tri,
        u=torch.where(valid, u2, 0.0),
        v=torch.where(valid, v2, 0.0),
    )


#: Transparent layers skipped per ray, as in the JAX package (a pinned
#: deviation from the reference, which walks on indefinitely).
MAX_ALPHA_RESTARTS = 4
_ALPHA_SKIP_EPS = 1e-3


@torch.no_grad()
def _hit_alpha(scene: Scene, hit: TriangleHit) -> torch.Tensor:
    """The sampled base-colour alpha at hits on alpha-blended materials;
    1.0 at hits on opaque materials and at misses (a decision: no
    gradient)."""
    tri = torch.clamp(hit.tri, min=0).long()
    geom = scene.geometry
    uvs = geom.uvs[tri]  # [..., 3, 2]
    mats = scene.materials
    mtable = torch.cat([mats.base_color, mats.base_color_tex,
                        mats.alpha_blend.to(torch.float32)[:, None]], dim=-1)
    mrows = mtable[geom.material_id[tri].long()]
    blend = mrows[..., 8] != 0.0
    u = hit.u[..., None]
    v = hit.v[..., None]
    w = 1.0 - u - v
    uv = w * uvs[..., 0, :] + u * uvs[..., 1, :] + v * uvs[..., 2, :]
    base = sample_material_channel(scene, mrows[..., 0:4], mrows[..., 4:8], uv,
                                   enabled=mats.tex_channels[0])
    return torch.where(hit.is_some & blend, base[..., 3], 1.0)


def _restart(o_cur, t_off, done, hit: TriangleHit, d):
    """Moves the rays that are not done just past their hit (by the skip
    epsilon on a miss) and adds the step to their distance so far. The
    origin advances as one fused multiply-add a component, as XLA:CPU
    compiles the JAX package's loop: the restarted rays then meet the same
    triangles, edges included."""
    step = torch.where(hit.is_some, hit.t, 0.0) + _ALPHA_SKIP_EPS
    o_cur = torch.where(done[..., None], o_cur, fma(d, step[..., None], o_cur))
    return o_cur, torch.where(done, t_off, t_off + step)


def trace_closest(scene: Scene, o: torch.Tensor, d: torch.Tensor) -> TriangleHit:
    """Closest opaque hit of rays o/d [..., 3]. On a scene with alpha
    blending, a hit whose sampled alpha is below 1 is skipped: the ray
    restarts just past it, MAX_ALPHA_RESTARTS times in all, without a look
    at the host (every ray takes every step)."""
    mesh = _TRACE_MESH.get()
    if mesh is not None:
        return _shard_over_rows(mesh, trace_closest, scene, o, d)
    if not scene.has_alpha:
        return _trace_closest_kernel(scene, o, d)
    zero = o[..., 0] * 0.0
    o_cur, t_off = o, zero
    done = torch.zeros_like(zero, dtype=torch.bool)
    bt, btri = zero + math.inf, torch.full_like(zero, -1, dtype=torch.int32)
    bu, bv = zero, zero
    for _ in range(MAX_ALPHA_RESTARTS):
        hit = _trace_closest_kernel(scene, o_cur, d)
        opaque = hit.is_some & (_hit_alpha(scene, hit) >= 1.0)
        accept = ~done & opaque
        bt = torch.where(accept, t_off + hit.t, bt)
        btri = torch.where(accept, hit.tri, btri)
        bu = torch.where(accept, hit.u, bu)
        bv = torch.where(accept, hit.v, bv)
        done = done | opaque | ~hit.is_some
        o_cur, t_off = _restart(o_cur, t_off, done, hit, d)
    return TriangleHit(t=bt, tri=btri, u=bu, v=bv)


@torch.no_grad()
def _trace_anyhit_alpha(scene: Scene, o, d, t_max) -> torch.Tensor:
    """Occlusion by opaque hits only: the restart loop of ``trace_closest``,
    each step a closest hit, counting a hit before t_max whose sampled
    alpha is 1."""
    zero = o[..., 0] * 0.0
    o_cur, t_off = o, zero
    done = torch.zeros_like(zero, dtype=torch.bool)
    occluded = torch.zeros_like(done)
    for _ in range(MAX_ALPHA_RESTARTS):
        hit = _trace_closest_kernel(scene, o_cur, d)
        in_range = hit.is_some & (t_off + hit.t < t_max)
        opaque = in_range & (_hit_alpha(scene, hit) >= 1.0)
        occluded = occluded | (~done & opaque)
        done = done | opaque | ~in_range
        o_cur, t_off = _restart(o_cur, t_off, done, hit, d)
    return occluded


def trace_anyhit(scene: Scene, o: torch.Tensor, d: torch.Tensor, t_max) -> torch.Tensor:
    """Occlusion query: True where any opaque triangle lies within t_max
    (kernel B; for a big scene with a BVH kernel 6, 9 or 11 or the torch
    BVH traversal, by the strategy; on a scene with alpha blending the
    restart loop of ``trace_closest``; on detached rays: a boolean carries
    no gradient)."""
    t_max = torch.broadcast_to(torch.as_tensor(t_max, device=o.device), o.shape[:-1])
    mesh = _TRACE_MESH.get()
    if mesh is not None:
        return _shard_over_rows(mesh, trace_anyhit, scene, o, d, t_max)
    t_max = t_max.detach().to(torch.float32).contiguous()
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    if scene.has_alpha:
        return _trace_anyhit_alpha(scene, o, d, t_max)
    if not is_big(scene):
        return tk.trace_anyhit_brute(packed_tri_rows(scene).detach(), o, d, t_max)
    if _stream_route(scene):
        return sk.stream_trace_anyhit(cluster_rows(scene), packed_geom_rows(scene).detach(), o,
                                      d, t_max)
    if BIG_SCENE_STRATEGY == "cluster":
        return ck.cluster_trace_anyhit(cluster_rows(scene), packed_geom_rows(scene).detach(), o,
                                       d, t_max)
    if _bvh_kernel_fits(scene):
        return bk.bvh_trace_anyhit(scene.bvh.node_rows, packed_geom_rows(scene).detach(),
                                   o, d, t_max)
    return trace_anyhit_bvh(scene, o, d, t_max)


def trace_surface(
    scene: Scene,
    o: torch.Tensor,
    d: torch.Tensor,
    regularize: bool = False,
    use_pallas: bool | None = None,
) -> Surface:
    """Closest hit + shading attributes as a Surface.

    ``use_pallas`` keeps the JAX package's meaning: ``None`` (the
    default) and ``True`` take the fused route. For a small scene that is
    kernel 4 (CUDA on the card, its plain version on CPU tensors), which
    resolves the winner's normal, uv and material id itself; for a big
    scene the strategy's kernel: kernel 8 ("cluster") or 10 ("packet",
    "jnp") resolve the winner as kernel 4 does, kernel 5 ("stream", or
    "cluster" on a scene the cluster kernels do not take) finds it and
    ``surface_at`` resolves it; a scene too big for kernel 10 takes
    trace_closest + surface_at. ``False`` takes trace_closest +
    surface_at, whose t/u/v are recomputed through the winner with tensor
    ops so that gradients flow (the differentiable path), as does a
    scene over BRUTE_FORCE_MAX_TRIS triangles without a BVH (kernel A).
    A scene with alpha blending takes trace_closest + surface_at too: the
    fused kernels have no alpha test. ``regularize`` clamps roughness for
    indirect bounces."""
    mesh = _TRACE_MESH.get()
    if mesh is not None:
        return _shard_over_rows(
            mesh, lambda s, oo, dd: trace_surface(s, oo, dd, regularize, use_pallas), scene, o, d)
    if use_pallas is False or scene.has_alpha or (
        scene.geometry.num_triangles > BRUTE_FORCE_MAX_TRIS and scene.bvh is None
    ):
        hit = trace_closest(scene, o, d)
        return surface_at(scene, o, d, hit, regularize=regularize)
    if is_big(scene) and _stream_route(scene):
        out = _stream_closest(scene, o, d)
        hit = TriangleHit(
            t=torch.where(out["hit"], out["t"], math.inf), tri=out["tri"], u=out["u"],
            v=out["v"],
        )
        return surface_at(scene, o, d, hit, regularize=regularize)
    rows = packed_geom_rows(scene).detach()
    od = (o.detach().contiguous(), d.detach().contiguous())
    if not is_big(scene):
        out = tk.trace_surface(rows, *od)
        some = out["tri"] >= 0
    elif BIG_SCENE_STRATEGY == "cluster":
        out = ck.cluster_trace_surface(cluster_rows(scene), rows, *od)
        some = out["hit"]
    elif _bvh_kernel_fits(scene):
        out = bk.bvh_trace_surface(scene.bvh.node_rows, rows, *od)
        some = out["hit"]
    else:
        hit = trace_closest(scene, o, d)
        return surface_at(scene, o, d, hit, regularize=regularize)
    t = torch.where(some, out["t"], 0.0)
    normal = out["normal"]
    mat_id = torch.where(some, out["mat_id"], 0)
    uv = out["uv"]
    base_color, emissive, metallic, roughness, reflectance = material_at(
        scene, mat_id.long(), uv, regularize
    )
    point = o + d * t[..., None] + normal * NUDGE_OFFSET

    def z(x):
        return torch.where(some[..., None] if x.ndim > some.ndim else some, x, 0.0)

    return Surface(
        point=z(point),
        dir=d,
        normal=z(normal),
        uv=z(uv),
        tri=torch.where(some, out["tri"], -1),
        material_id=mat_id,
        base_color=z(base_color),
        emissive=z(emissive),
        metallic=z(metallic),
        roughness=z(roughness),
        reflectance=z(reflectance),
        depth=t,
        is_some=some,
    )
