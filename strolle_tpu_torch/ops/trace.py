"""Ray tracing entry points, closest hit and any hit (port of the
small-scene branches of strolle_tpu/ops/trace.py).

Scenes of up to BRUTE_FORCE_MAX_TRIS triangles go through the
brute-force kernels of ops/kernels/trace_kernels.py (CUDA on the card,
their plain versions on the CPU). Bigger scenes, alpha-blended
materials, and the fused surface kernel are later slices of the port
and raise NotImplementedError here.
"""

from __future__ import annotations

import math

import torch

from ..scene.types import Scene
from .hit import NUDGE_OFFSET, Surface, TriangleHit, surface_at
from .intersect import ray_triangle
from .kernels import trace_kernels as tk

BRUTE_FORCE_MAX_TRIS = tk.MAX_TRIS


def check_scene_supported(scene: Scene) -> None:
    """Raises for the scene features that later slices of the port add."""
    if scene.geometry.num_triangles > BRUTE_FORCE_MAX_TRIS:
        raise NotImplementedError(
            f"{scene.geometry.num_triangles} triangles > {BRUTE_FORCE_MAX_TRIS}: "
            "the big-scene stream kernels are ported in slice 3"
        )
    if scene.has_alpha:
        raise NotImplementedError("alpha-blended materials are ported in slice 3")
    if scene.atlas is not None:
        raise NotImplementedError("textured materials (atlas) are ported in slice 3")


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


def _trace_closest_kernel(scene: Scene, o, d) -> TriangleHit:
    """Kernel A finds the winning triangle on detached rays; t/u/v are
    then recomputed through that triangle with plain tensor ops, so
    gradients with respect to rays and vertices flow."""
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
    """Occlusion query: True where any triangle lies within t_max
    (kernel B on detached rays; a boolean carries no gradient)."""
    check_scene_supported(scene)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, device=o.device), o.shape[:-1])
    return tk.trace_anyhit_brute(
        packed_tri_rows(scene).detach(),
        o.detach().contiguous(),
        d.detach().contiguous(),
        t_max.detach().to(torch.float32).contiguous(),
    )


def trace_surface(
    scene: Scene,
    o: torch.Tensor,
    d: torch.Tensor,
    regularize: bool = False,
    use_pallas: bool | None = None,
) -> Surface:
    """Closest hit + shading attributes as a Surface.

    ``use_pallas`` keeps the JAX package's meaning: ``None`` (the
    default) and ``True`` take the fused surface kernel (kernel 4: CUDA
    on the card, its plain version on CPU tensors), which resolves the
    winner's normal, uv and material id itself; ``False`` takes
    trace_closest + surface_at, whose t/u/v are recomputed through the
    winner with tensor ops so that gradients flow (the differentiable
    path). ``regularize`` clamps roughness for indirect bounces."""
    check_scene_supported(scene)
    if use_pallas is False:
        hit = trace_closest(scene, o, d)
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
    mid = mat_id.long()
    mats = scene.materials
    roughness = mats.roughness[mid]
    if regularize:
        roughness = torch.clamp(roughness, min=0.75 * 0.75)
    point = o + d * t[..., None] + normal * NUDGE_OFFSET

    def z(x):
        return torch.where(some[..., None] if x.ndim > some.ndim else some, x, 0.0)

    return Surface(
        point=z(point),
        dir=d,
        normal=z(normal),
        uv=z(out["uv"]),
        tri=torch.where(some, out["tri"], -1),
        material_id=mat_id,
        base_color=z(mats.base_color[mid]),
        emissive=z(mats.emissive[mid][..., :3]),
        metallic=z(mats.metallic[mid]),
        roughness=z(roughness),
        reflectance=z(mats.reflectance[mid]),
        depth=t,
        is_some=some,
    )
