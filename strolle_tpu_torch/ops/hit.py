"""Hit records and surface attributes (port of strolle_tpu/ops/hit.py).

Only untextured materials are ported: a scene with an atlas is refused
before it reaches this module, so every material channel is its
multiplier.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.types import Scene
from . import math as vm

#: Self-intersection nudge along the shading normal.
NUDGE_OFFSET = 0.01


@dataclasses.dataclass(frozen=True)
class TriangleHit:
    """Closest-hit result per ray; tri < 0 means miss (t = +inf)."""

    t: torch.Tensor  # f32[...]
    tri: torch.Tensor  # i32[...]
    u: torch.Tensor  # f32[...]
    v: torch.Tensor  # f32[...]

    @property
    def is_some(self) -> torch.Tensor:
        return self.tri >= 0


@dataclasses.dataclass(frozen=True)
class Surface:
    """Shading-ready attributes at a hit; zero where ``is_some`` is False."""

    point: torch.Tensor  # f32[..., 3]  (nudged off the surface)
    dir: torch.Tensor  # f32[..., 3]  incoming ray direction
    normal: torch.Tensor  # f32[..., 3]
    uv: torch.Tensor  # f32[..., 2]
    tri: torch.Tensor  # i32[...]  winning triangle (-1 on miss)
    material_id: torch.Tensor  # i32[...]
    base_color: torch.Tensor  # f32[..., 4]
    emissive: torch.Tensor  # f32[..., 3]
    metallic: torch.Tensor  # f32[...]
    roughness: torch.Tensor  # f32[...]
    reflectance: torch.Tensor  # f32[...]
    depth: torch.Tensor  # f32[...]  (hit distance; 0 on miss)
    is_some: torch.Tensor  # bool[...]

    def replace(self, **updates) -> "Surface":
        return dataclasses.replace(self, **updates)

    @staticmethod
    def empty(shape, device) -> "Surface":
        """A miss everywhere: zeros, tri = -1."""
        def z(*tail, dtype=torch.float32):
            return torch.zeros(tuple(shape) + tail, dtype=dtype, device=device)

        return Surface(
            point=z(3), dir=z(3), normal=z(3), uv=z(2),
            tri=torch.full(tuple(shape), -1, dtype=torch.int32, device=device),
            material_id=z(dtype=torch.int32), base_color=z(4), emissive=z(3),
            metallic=z(), roughness=z(), reflectance=z(), depth=z(),
            is_some=z(dtype=torch.bool),
        )


def surface_at(
    scene: Scene,
    o: torch.Tensor,
    d: torch.Tensor,
    hit: TriangleHit,
    regularize: bool = False,
) -> Surface:
    """Gathers the winning triangle's data and interpolates shading
    attributes; the normal is flipped to face against the ray by the
    sign of the Möller-Trumbore determinant. ``regularize`` clamps
    roughness for indirect bounces (roughness >= 0.5625)."""
    if scene.atlas is not None:
        raise NotImplementedError(
            "textured materials (atlas sampling) are ported in slice 3"
        )
    geom = scene.geometry
    mats = scene.materials
    tri = torch.clamp(hit.tri, min=0).long()

    p = geom.positions[tri]  # [..., 3, 3]
    n = geom.normals[tri]
    uvs = geom.uvs[tri]
    mat_id = geom.material_id[tri].long()

    u = hit.u[..., None]
    v = hit.v[..., None]
    w = 1.0 - u - v

    e1 = p[..., 1, :] - p[..., 0, :]
    e2 = p[..., 2, :] - p[..., 0, :]
    det = vm.dot(e1, vm.cross(d, e2))
    normal = vm.normalize(w * n[..., 0, :] + u * n[..., 1, :] + v * n[..., 2, :])
    normal = normal * vm.copysign1(det)[..., None]

    uv = w * uvs[..., 0, :] + u * uvs[..., 1, :] + v * uvs[..., 2, :]

    base_color = mats.base_color[mat_id]
    emissive = mats.emissive[mat_id][..., :3]
    roughness = mats.roughness[mat_id]
    metallic = mats.metallic[mat_id]
    if regularize:
        roughness = torch.clamp(roughness, min=0.75 * 0.75)

    some = hit.is_some
    t0 = torch.where(some, hit.t, 0.0)
    point = o + d * t0[..., None] + normal * NUDGE_OFFSET

    def z(x):
        return torch.where(some[..., None] if x.ndim > some.ndim else some, x, 0.0)

    return Surface(
        point=z(point),
        dir=d,
        normal=z(normal),
        uv=z(uv),
        tri=torch.where(some, hit.tri, -1),
        material_id=torch.where(some, mat_id.to(torch.int32), 0),
        base_color=z(base_color),
        emissive=z(emissive),
        metallic=z(metallic),
        roughness=z(roughness),
        reflectance=z(mats.reflectance[mat_id]),
        depth=t0,
        is_some=some,
    )
