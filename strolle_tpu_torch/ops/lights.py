"""Light radiance and shadow-ray sampling (port of
strolle_tpu/ops/lights.py). The JAX package fetches a light's row with
a one-hot matmul; here it is plain indexing of the same [L, 13] table."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.types import LIGHT_POINT, Lights
from . import brdf, math as vm, rng


class LightGather(NamedTuple):
    """Per-lane light parameters (one light per lane, gathered by id)."""

    pos: torch.Tensor  # f32[..., 3]
    radius: torch.Tensor  # f32[...]
    color: torch.Tensor  # f32[..., 3]
    range: torch.Tensor  # f32[...]
    kind: torch.Tensor  # i32[...]
    spot_dir: torch.Tensor  # f32[..., 3]
    spot_angle: torch.Tensor  # f32[...]


#: Finite stand-in for "unlimited range" in the packed light rows.
RANGE_UNLIMITED = 1e30


def pack_lights(lights: Lights, prev: bool = False) -> torch.Tensor:
    """[L, 13] rows: pos(3) radius color(3) range kind spot_dir(3)
    spot_angle, clamped to RANGE_UNLIMITED (also the megakernel's light
    rows). ``prev`` packs the previous frame's copies."""
    if prev:
        cols = [
            lights.prev_pos, lights.prev_radius[:, None], lights.prev_color,
            lights.prev_range[:, None], lights.prev_kind.to(torch.float32)[:, None],
            lights.prev_spot_dir, lights.prev_spot_angle[:, None],
        ]
    else:
        cols = [
            lights.pos, lights.radius[:, None], lights.color,
            lights.range[:, None], lights.kind.to(torch.float32)[:, None],
            lights.spot_dir, lights.spot_angle[:, None],
        ]
    return torch.clamp(torch.cat(cols, dim=-1), max=RANGE_UNLIMITED)


def light_gather_of(rows: torch.Tensor) -> LightGather:
    """A LightGather over packed rows [..., 13]."""
    return LightGather(
        pos=rows[..., 0:3],
        radius=rows[..., 3],
        color=rows[..., 4:7],
        range=rows[..., 7],
        kind=rows[..., 8].to(torch.int32),
        spot_dir=rows[..., 9:12],
        spot_angle=rows[..., 12],
    )


def gather_light(lights: Lights, light_id: torch.Tensor, prev: bool = False) -> LightGather:
    i = torch.clamp(torch.as_tensor(light_id), 0, lights.capacity - 1).long()
    return light_gather_of(pack_lights(lights, prev)[i])


class LightRadiance(NamedTuple):
    radiance: torch.Tensor  # f32[..., 3]
    diff_brdf: torch.Tensor  # f32[..., 3]
    spec_brdf: torch.Tensor  # f32[..., 3]

    @property
    def sum(self) -> torch.Tensor:
        return self.radiance * (self.diff_brdf + self.spec_brdf)


def _rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=1e-20))


def radiance(light: LightGather, surf) -> LightRadiance:
    """Sphere light with spot falloff, smooth inverse-square range
    attenuation, Lambert cosine, diffuse BRDF and representative-point
    specular, against a Surface."""
    l_vec = light.pos - surf.point

    # spot-angle falloff; the clip stays strictly inside (-1, 1)
    to_point = vm.normalize(surf.point - light.pos)
    cosang = torch.clamp(
        vm.dot(vm.normalize(light.spot_dir), to_point), -1.0 + 1e-6, 1.0 - 1e-6
    )
    angle = torch.arccos(cosang)
    q = angle / torch.clamp(light.spot_angle, min=1e-6)
    spot_f = vm.saturate(1.0 - q * q * q)
    f_angle = torch.where(light.kind == LIGHT_POINT, 1.0, spot_f)

    # smooth inverse-square distance falloff
    l2 = vm.dot(l_vec, l_vec)
    inv_r2 = 1.0 / torch.clamp(light.range * light.range, min=1e-12)
    factor = l2 * inv_r2
    smooth = vm.saturate(1.0 - factor * factor)
    attenuation = smooth * smooth / torch.clamp(l2, min=1e-4)
    unlimited = torch.isinf(light.range) | (light.range >= RANGE_UNLIMITED)
    f_dist = torch.where(unlimited, 1.0, attenuation)

    f_cos = vm.saturate(vm.dot(surf.normal, vm.normalize(l_vec)))

    diff = brdf.diffuse_eval(surf.base_color, surf.metallic)

    # representative-point sphere-light specular
    v = -surf.dir
    n = surf.normal
    r = vm.reflect(-v, n)
    center_to_ray = vm.dotk(l_vec, r) * r - l_vec
    t = vm.saturate(light.radius * _rsqrt(vm.dot(center_to_ray, center_to_ray)))
    closest = l_vec + center_to_ray * t[..., None]
    inv_len = _rsqrt(vm.dot(closest, closest))
    cr = brdf.clamped_roughness(surf.roughness)
    i_rough = cr / vm.saturate(cr + light.radius * 0.5 * inv_len)
    spec_dir = closest * inv_len[..., None]
    spec = (i_rough * i_rough)[..., None] * brdf.specular_eval(
        surf.base_color, surf.metallic, surf.roughness, surf.reflectance,
        n, spec_dir, v,
    )

    rad = light.color * (f_angle * f_dist * f_cos)[..., None]
    return LightRadiance(radiance=rad, diff_brdf=diff, spec_brdf=spec)


def shadow_ray_wnoise(state, light: LightGather, hit_point):
    """Shadow ray FROM a point on the light sphere TOWARD the hit.
    Returns (state, origin, dir, length)."""
    state, sph = rng.sample_sphere(state)
    light_pos = light.pos + light.radius[..., None] * sph
    to_hit = hit_point - light_pos
    return state, light_pos, vm.normalize(to_hit), vm.length(to_hit)


def shadow_ray_bnoise(sample2, light: LightGather, hit_point):
    """Blue-noise disk sample toward the light; returns (origin, dir,
    length) with the light -> hit orientation of the reference."""
    to_light = light.pos - hit_point
    dist = vm.length(to_light)
    ldir = to_light / torch.clamp(dist, min=1e-20)[..., None]
    lrad = light.radius / torch.clamp(dist, min=1e-20)
    tangent, bitangent = vm.any_orthonormal_pair(ldir)

    angle = 2.0 * math.pi * sample2[..., 0]
    radius = torch.sqrt(torch.clamp(sample2[..., 1], min=0.0))
    dx = torch.sin(angle) * radius * lrad
    dy = torch.cos(angle) * radius * lrad

    ray_dir = vm.normalize(ldir + dx[..., None] * tangent + dy[..., None] * bitangent)
    origin = hit_point + ray_dir * dist[..., None]
    return origin, -ray_dir, dist
