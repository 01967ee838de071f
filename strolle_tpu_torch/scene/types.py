"""Scene representation: dataclasses of tensors (port of
strolle_tpu/scene/types.py).

Every tensor of a scene lies on one device. The static flags that pick
kernel variants (``flat_normals``, ``has_metal``, ``has_alpha``,
``Materials.tex_channels``) and the live light count are plain Python
values, so no launch has to read a tensor back to decide.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.texture import packed_corner_matrix

LIGHT_NONE = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2


def _to(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """World-space triangle soup, SoA over the triangle axis."""

    positions: torch.Tensor  # f32[T, 3, 3]
    normals: torch.Tensor  # f32[T, 3, 3]
    uvs: torch.Tensor  # f32[T, 3, 2]
    tangents: torch.Tensor  # f32[T, 3, 4]
    material_id: torch.Tensor  # i32[T]

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]


@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA materials. Texture fields are atlas rects [x, y, w, h]; an
    all-zero rect means untextured."""

    base_color: torch.Tensor  # f32[M, 4]
    base_color_tex: torch.Tensor  # f32[M, 4]
    emissive: torch.Tensor  # f32[M, 4]
    emissive_tex: torch.Tensor  # f32[M, 4]
    roughness: torch.Tensor  # f32[M]
    metallic: torch.Tensor  # f32[M]
    reflectance: torch.Tensor  # f32[M]
    ior: torch.Tensor  # f32[M]
    metallic_roughness_tex: torch.Tensor  # f32[M, 4]
    normal_map_tex: torch.Tensor  # f32[M, 4]
    alpha_blend: torch.Tensor  # i32[M]
    #: Whether any material textures each channel, in the order
    #: (base_color, emissive, metallic_roughness).
    tex_channels: tuple = (True, True, True)

    @property
    def num_materials(self) -> int:
        return self.base_color.shape[0]


@dataclasses.dataclass(frozen=True)
class Lights:
    """Slot-indexed lights with previous-frame copies, padded to a fixed
    capacity; ``count`` live slots, as a Python int."""

    pos: torch.Tensor  # f32[L, 3]
    radius: torch.Tensor  # f32[L]
    color: torch.Tensor  # f32[L, 3]
    range: torch.Tensor  # f32[L]
    kind: torch.Tensor  # i32[L]
    spot_dir: torch.Tensor  # f32[L, 3]
    spot_angle: torch.Tensor  # f32[L]
    prev_pos: torch.Tensor  # f32[L, 3]
    prev_radius: torch.Tensor  # f32[L]
    prev_color: torch.Tensor  # f32[L, 3]
    prev_range: torch.Tensor  # f32[L]
    prev_kind: torch.Tensor  # i32[L]
    prev_spot_dir: torch.Tensor  # f32[L, 3]
    prev_spot_angle: torch.Tensor  # f32[L]
    remap: torch.Tensor  # i32[L]  (-1 = untouched, else new slot id)
    killed: torch.Tensor  # i32[L]
    count: int

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass(frozen=True)
class Atlas:
    """One texture atlas: the linear-colour image and its RGBA8-packed
    four-corner table (``ops/texture.packed_corner_matrix``), built once
    per scene rather than once per texture fetch. Make it with
    ``make_atlas``."""

    image: torch.Tensor  # f32[A, A, 4], linear colour
    corners: torch.Tensor  # i32[A*A, 4], RGBA8 bit patterns


def make_atlas(image) -> Atlas:
    image = torch.as_tensor(image, dtype=torch.float32)
    return Atlas(image=image, corners=packed_corner_matrix(image))


@dataclasses.dataclass(frozen=True)
class Motion:
    """Per-instance object motion for the velocity of moving objects: each
    instance's previous transform times the inverse of its current one,
    baked on the host into one row-major 3x4 affine, so that
    prev_point = A @ [point, 1]."""

    instance_id: torch.Tensor  # i32[T] per-triangle instance slot
    prev_of_curr: torch.Tensor  # f32[I, 12] row-major 3x4 affine

    def replace(self, **updates) -> "Motion":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class Scene:
    geometry: Geometry
    materials: Materials
    lights: Lights
    atlas: Optional[Atlas]
    sun_azimuth: float
    sun_altitude: float
    #: Flattened BVH (``bvh.scene_with_bvh``), None until built.
    bvh: Optional["object"] = None
    #: Per-instance previous transforms; None for a static scene, whose
    #: velocity comes from camera motion alone.
    motion: Optional[Motion] = None
    #: Cluster boxes [K, 8] of the big-scene kernels, built with the BVH
    #: (``bvh.build_clusters``); None for scenes of up to 1024 triangles.
    clusters: Optional[torch.Tensor] = None
    has_alpha: bool = False
    flat_normals: bool = False
    has_metal: bool = True

    def replace(self, **updates) -> "Scene":
        return dataclasses.replace(self, **updates)


def compute_static_flags(geometry: Geometry, materials: Materials) -> dict:
    """The kernel-specialisation flags of a scene, read on the host."""
    n = geometry.normals.detach().cpu().numpy()
    flat = bool(
        np.allclose(n[:, 0], n[:, 1], atol=1e-5)
        and np.allclose(n[:, 0], n[:, 2], atol=1e-5)
        and np.allclose((n[:, 0] ** 2).sum(-1), 1.0, atol=1e-3)
    )
    mids = geometry.material_id.detach().cpu().numpy()
    metallic = materials.metallic.detach().cpu().numpy()
    used = np.unique(np.clip(mids, 0, metallic.shape[0] - 1))
    has_metal = bool((metallic[used] > 0.0).any())
    return {"flat_normals": flat, "has_metal": has_metal}


def make_materials(records: list[dict], device=None) -> Materials:
    """Builds Materials from a list of per-material dicts."""
    device = resolve_device(device)
    n = max(len(records), 1)

    def arr(key, default):
        out = [r.get(key, default) for r in records]
        while len(out) < n:
            out.append(default)
        return np.asarray(out, np.float32)

    zeros4 = [0.0, 0.0, 0.0, 0.0]
    host = dict(
        base_color=arr("base_color", [1.0, 1.0, 1.0, 1.0]),
        base_color_tex=arr("base_color_tex", zeros4),
        emissive=arr("emissive", zeros4),
        emissive_tex=arr("emissive_tex", zeros4),
        roughness=arr("roughness", 1.0),
        metallic=arr("metallic", 0.0),
        reflectance=arr("reflectance", 0.5),
        ior=arr("ior", 1.47),
        metallic_roughness_tex=arr("metallic_roughness_tex", zeros4),
        normal_map_tex=arr("normal_map_tex", zeros4),
    )
    alpha = [int(r.get("alpha_blend", 0)) for r in records]
    alpha += [0] * (n - len(records))
    tex_channels = tuple(
        bool(np.any(host[k] != 0.0))
        for k in ("base_color_tex", "emissive_tex", "metallic_roughness_tex")
    )
    return Materials(
        **{k: _to(v, device) for k, v in host.items()},
        alpha_blend=_to(alpha, device, torch.int32),
        tex_channels=tex_channels,
    )


def make_lights(records: list[dict], capacity: int | None = None, device=None) -> Lights:
    """Builds Lights from per-light dicts, padded to ``capacity``."""
    device = resolve_device(device)
    count = len(records)
    cap = capacity or max(count, 1)
    if cap < count:
        raise ValueError(f"light capacity {cap} < {count} lights")

    def arr(key, default):
        out = [r.get(key, default) for r in records]
        while len(out) < cap:
            out.append(
                default if not isinstance(default, list) else [0.0] * len(default)
            )
        return _to(np.asarray(out, np.float32), device)

    kind = [int(r.get("kind", LIGHT_POINT)) for r in records]
    kind += [LIGHT_NONE] * (cap - count)
    kind_t = _to(kind, device, torch.int32)
    return Lights(
        pos=arr("pos", [0.0, 0.0, 0.0]),
        radius=arr("radius", 0.1),
        color=arr("color", [1.0, 1.0, 1.0]),
        range=arr("range", np.inf),
        kind=kind_t,
        spot_dir=arr("spot_dir", [0.0, -1.0, 0.0]),
        spot_angle=arr("spot_angle", 0.0),
        prev_pos=arr("pos", [0.0, 0.0, 0.0]),
        prev_radius=arr("radius", 0.1),
        prev_color=arr("color", [1.0, 1.0, 1.0]),
        prev_range=arr("range", np.inf),
        prev_kind=kind_t.clone(),
        prev_spot_dir=arr("spot_dir", [0.0, -1.0, 0.0]),
        prev_spot_angle=arr("spot_angle", 0.0),
        remap=_to(np.full((cap,), -1), device, torch.int32),
        killed=_to(np.zeros((cap,)), device, torch.int32),
        count=count,
    )


def commit_lights(lights: Lights) -> Lights:
    """The lights with their current data copied into the previous-frame
    slots and the kill/remap markers cleared (one frame's flush)."""
    return dataclasses.replace(
        lights,
        prev_pos=lights.pos,
        prev_radius=lights.radius,
        prev_color=lights.color,
        prev_range=lights.range,
        prev_kind=lights.kind,
        prev_spot_dir=lights.spot_dir,
        prev_spot_angle=lights.spot_angle,
        remap=torch.full_like(lights.remap, -1),
        killed=torch.zeros_like(lights.killed),
    )
