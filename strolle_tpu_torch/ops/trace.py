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

The alpha restart loop and the mesh sharding context are later slices
of the port and raise NotImplementedError here.
"""

from __future__ import annotations

import math

import torch

from ..bvh.traverse import trace_anyhit_bvh, trace_closest_bvh
from ..scene.types import Scene
from .hit import NUDGE_OFFSET, Surface, TriangleHit, material_at, surface_at
from .intersect import ray_triangle
from .kernels import bvh_kernels as bk
from .kernels import cluster_kernels as ck
from .kernels import stream_kernels as sk
from .kernels import trace_kernels as tk

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


def check_scene_supported(scene: Scene) -> None:
    """Raises for the scene features that later slices of the port add."""
    if scene.has_alpha:
        raise NotImplementedError(
            "alpha-blended materials (the alpha restart loop) are a later slice of the port "
            "(ROADMAP.md section 1, item 4)"
        )


def trace_rows_sharded(mesh):
    """The JAX package's context that shards ray rows over a device mesh;
    the multi-device layer is a later slice of the port (ROADMAP.md
    section 1, item 12)."""
    raise NotImplementedError(
        "trace_rows_sharded: the multi-device layer is a later slice of the port "
        "(ROADMAP.md section 1, item 12)"
    )


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


def trace_closest(scene: Scene, o: torch.Tensor, d: torch.Tensor) -> TriangleHit:
    """Closest opaque hit of rays o/d [..., 3]."""
    check_scene_supported(scene)
    return _trace_closest_kernel(scene, o, d)


def trace_anyhit(scene: Scene, o: torch.Tensor, d: torch.Tensor, t_max) -> torch.Tensor:
    """Occlusion query: True where any triangle lies within t_max (kernel
    B; for a big scene with a BVH kernel 6, 9 or 11 or the torch BVH
    traversal, by the strategy; on detached rays: a boolean carries no
    gradient)."""
    check_scene_supported(scene)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, device=o.device), o.shape[:-1])
    t_max = t_max.detach().to(torch.float32).contiguous()
    o = o.detach().contiguous()
    d = d.detach().contiguous()
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
    ``regularize`` clamps roughness for indirect bounces."""
    check_scene_supported(scene)
    if use_pallas is False or (
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
