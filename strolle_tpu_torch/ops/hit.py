"""Hit records and surface attributes (port of strolle_tpu/ops/hit.py).

Material channels are sampled from the scene's texture atlas where a
material textures them (``ops/texture.py``); a channel that no material
textures (``Materials.tex_channels``) skips the fetch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.types import Scene
from . import math as vm
from .texture import sample_material_channel

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


def material_at(scene: Scene, mat_id: torch.Tensor, uv: torch.Tensor, regularize: bool):
    """The material of ``mat_id`` [...] at texture coordinates ``uv``
    [..., 2]: (base_color [..., 4], emissive [..., 3], metallic,
    roughness, reflectance). The metallic-roughness texel's G scales
    roughness and its B metallic; ``regularize`` clamps roughness to
    >= 0.5625 for indirect bounces."""
    mats = scene.materials
    tex_base, tex_emis, tex_mr = mats.tex_channels
    base_color = sample_material_channel(
        scene, mats.base_color[mat_id], mats.base_color_tex[mat_id], uv, enabled=tex_base
    )
    emissive = sample_material_channel(
        scene, mats.emissive[mat_id], mats.emissive_tex[mat_id], uv, enabled=tex_emis
    )[..., :3]
    rough_f = mats.roughness[mat_id]
    metal_f = mats.metallic[mat_id]
    if tex_mr and scene.atlas is not None:
        one = torch.ones_like(rough_f)
        mr = sample_material_channel(
            scene, torch.stack([one, rough_f, metal_f, one], dim=-1),
            mats.metallic_roughness_tex[mat_id], uv,
        )
        rough_f, metal_f = mr[..., 1], mr[..., 2]
    if regularize:
        rough_f = torch.clamp(rough_f, min=0.75 * 0.75)
    return base_color, emissive, metal_f, rough_f, mats.reflectance[mat_id]


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
    geom = scene.geometry
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
    base_color, emissive, metallic, roughness, reflectance = material_at(
        scene, mat_id, uv, regularize
    )

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
        reflectance=z(reflectance),
        depth=t0,
        is_some=some,
    )
