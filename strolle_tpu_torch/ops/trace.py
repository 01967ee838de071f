"""Ray tracing entry points, closest hit and any hit (port of
strolle_tpu/ops/trace.py).

Scenes of up to BRUTE_FORCE_MAX_TRIS triangles go through the
brute-force kernels of ops/kernels/trace_kernels.py; bigger scenes, once
``bvh.scene_with_bvh`` has built their clusters, through the stream
kernels of ops/kernels/stream_kernels.py (the JAX package's default
``BIG_SCENE_STRATEGY = "stream"``). Each runs CUDA on the card and its
plain version on the CPU. The JAX package's other big-scene strategies
("cluster", "packet", "jnp"), its alpha restart loop and its mesh
sharding context are later slices of the port and raise
NotImplementedError here.
"""

from __future__ import annotations

import math

import torch

from ..scene.types import Scene
from .hit import NUDGE_OFFSET, Surface, TriangleHit, material_at, surface_at
from .intersect import ray_triangle
from .kernels import stream_kernels as sk
from .kernels import trace_kernels as tk

BRUTE_FORCE_MAX_TRIS = tk.MAX_TRIS
#: The big-scene strategy; only the JAX package's default is ported.
BIG_SCENE_STRATEGY = "stream"


def is_big(scene: Scene) -> bool:
    return scene.geometry.num_triangles > BRUTE_FORCE_MAX_TRIS


def check_scene_supported(scene: Scene) -> None:
    """Raises for the scene features that later slices of the port add."""
    if is_big(scene):
        if scene.clusters is None:
            raise NotImplementedError(
                f"{scene.geometry.num_triangles} triangles > {BRUTE_FORCE_MAX_TRIS} without "
                "clusters: build them with bvh.scene_with_bvh (the torch BVH traversal of "
                "strolle_tpu/bvh/traverse.py is not ported)"
            )
        if BIG_SCENE_STRATEGY != "stream":
            raise NotImplementedError(
                f"BIG_SCENE_STRATEGY={BIG_SCENE_STRATEGY!r}: the cluster, packet and jnp "
                "strategies are later slices of the port (ROADMAP.md section 2, kernels 8-11)"
            )
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
        scene.clusters.detach(),
        packed_geom_rows(scene).detach(),
        o.detach().contiguous(),
        d.detach().contiguous(),
    )


def _trace_closest_kernel(scene: Scene, o, d) -> TriangleHit:
    """The kernel (A, or 5 for a big scene) finds the winning triangle on
    detached rays; t/u/v are then recomputed through that triangle with
    plain tensor ops, so gradients with respect to rays and vertices
    flow."""
    if is_big(scene):
        tri = _stream_closest(scene, o, d)["tri"]
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
    B, or kernel 6 for a big scene, on detached rays; a boolean carries no
    gradient)."""
    check_scene_supported(scene)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, device=o.device), o.shape[:-1])
    t_max = t_max.detach().to(torch.float32).contiguous()
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    if is_big(scene):
        return sk.stream_trace_anyhit(
            scene.clusters.detach(), packed_geom_rows(scene).detach(), o, d, t_max
        )
    return tk.trace_anyhit_brute(packed_tri_rows(scene).detach(), o, d, t_max)


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
    scene kernel 5 finds the winner and ``surface_at`` resolves it.
    ``False`` takes trace_closest + surface_at, whose t/u/v are recomputed
    through the winner with tensor ops so that gradients flow (the
    differentiable path). ``regularize`` clamps roughness for indirect
    bounces."""
    check_scene_supported(scene)
    if use_pallas is False:
        hit = trace_closest(scene, o, d)
        return surface_at(scene, o, d, hit, regularize=regularize)
    if is_big(scene):
        out = _stream_closest(scene, o, d)
        hit = TriangleHit(
            t=torch.where(out["hit"], out["t"], math.inf), tri=out["tri"], u=out["u"],
            v=out["v"],
        )
        return surface_at(scene, o, d, hit, regularize=regularize)

    out = tk.trace_surface(
        packed_geom_rows(scene).detach(),
        o.detach().contiguous(),
        d.detach().contiguous(),
    )
    some = out["tri"] >= 0
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
