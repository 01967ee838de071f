"""Brute-force path-traced reference mode (port of
strolle_tpu/models/reference.py).

By default one sample of every pixel is one launch of the megakernel
(ops/kernels/ref_kernel.py). ``use_megakernel=False`` runs the staged
loop instead — per bounce a closest-hit launch (kernel A), the shading
in tensor ops, and a shadow-ray any-hit launch (kernel B) — which is
the megakernel's oracle and the forward pass that gradients take.
Accumulation across frames resets when the camera moves by more than
0.0025 in any entry of its projection-view matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera import Camera, pixel_rays, screen_grid
from ..ops import brdf, rng
from ..ops.kernels.ref_kernel import (
    pack_geometry_bw,
    pack_lights,
    pack_materials,
    trace_sample_megakernel,
)
from ..ops.lights import gather_light, radiance, shadow_ray_wnoise
from ..ops.trace import check_scene_supported, trace_anyhit, trace_surface
from ..scene.types import Scene


@dataclasses.dataclass(frozen=True)
class RefAccumulator:
    """Running average state: the sum of samples and the camera at the
    last accumulation."""

    color: torch.Tensor  # f32[H, W, 3]  sum of samples
    samples: torch.Tensor  # f32[H, W]   sample count
    projection_view: torch.Tensor  # f32[4, 4]


def init_accumulator(camera: Camera) -> RefAccumulator:
    h, w = camera.height, camera.width
    dev = camera.device
    return RefAccumulator(
        color=torch.zeros((h, w, 3), dtype=torch.float32, device=dev),
        samples=torch.zeros((h, w), dtype=torch.float32, device=dev),
        projection_view=torch.zeros((4, 4), dtype=torch.float32, device=dev),
    )


def _check_supported(scene: Scene, include_sky: bool) -> None:
    if include_sky:
        raise NotImplementedError("the sky (include_sky=True) is ported in slice 3")
    check_scene_supported(scene)


def sample_pixels(
    scene: Scene,
    camera: Camera,
    grid: torch.Tensor,  # i32[..., 2] pixel coords
    seed,
    depth: int = 5,
    include_sky: bool = True,
    use_megakernel: bool | None = None,
) -> torch.Tensor:
    """One path-traced sample for each pixel in ``grid``; radiance
    [..., 3]: emissive + one-light NEE + layered-BRDF continuation, with
    roughness regularised after the first bounce."""
    _check_supported(scene, include_sky)
    o, d = pixel_rays(camera, grid)
    state = rng.wnoise_new(seed, grid[..., 0], grid[..., 1])
    if use_megakernel is not False:
        return _sample_pixels_megakernel(scene, o, d, state, depth)

    hw = o.shape[:-1]
    dev = o.device
    color = torch.zeros(hw + (3,), dtype=torch.float32, device=dev)
    throughput = torch.ones(hw + (3,), dtype=torch.float32, device=dev)
    alive = torch.ones(hw, dtype=torch.bool, device=dev)
    lcount = scene.lights.count
    has_lights = lcount > 0
    light_pdf = 1.0 / max(float(lcount), 1.0)

    for bounce in range(depth + 1):
        surf = trace_surface(scene, o, d, regularize=bounce > 0, use_pallas=False)
        alive = alive & surf.is_some

        # emissive
        color = torch.where(alive[..., None], color + throughput * surf.emissive, color)

        # next-event estimation: one uniformly chosen light
        state, word = rng.next_u32(state)
        light = gather_light(scene.lights, word % max(lcount, 1))
        state, sr_o, sr_d, sr_len = shadow_ray_wnoise(state, light, surf.point)
        occluded = trace_anyhit(scene, sr_o, sr_d, sr_len)
        nee = radiance(light, surf).sum / light_pdf
        take = alive & ~occluded if has_lights else torch.zeros_like(alive)
        color = torch.where(take[..., None], color + throughput * nee, color)

        # continuation ray
        if bounce < depth:
            state, new_dir, pdf, rad = brdf.layered_sample(
                state,
                surf.base_color,
                surf.metallic,
                surf.roughness,
                surf.reflectance,
                surf.normal,
                -d,
            )
            alive = alive & (pdf > 0.0)
            cos = (
                new_dir[..., 0] * surf.normal[..., 0]
                + new_dir[..., 1] * surf.normal[..., 1]
                + new_dir[..., 2] * surf.normal[..., 2]
            )
            throughput = throughput * (
                cos[..., None] * rad / torch.clamp(pdf, min=1e-20)[..., None]
            )
            o = surf.point
            d = torch.where(alive[..., None], new_dir, d)

    return color


def _sample_pixels_megakernel(scene: Scene, o, d, state, depth: int) -> torch.Tensor:
    rows = pack_geometry_bw(scene.geometry)
    pad = (-rows.shape[0]) % 8
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, 24))])
    return trace_sample_megakernel(
        rows.detach().contiguous(),
        pack_materials(scene.materials).detach().contiguous(),
        pack_lights(scene.lights).detach().contiguous(),
        scene.lights.count,
        o.detach().contiguous(),
        d.detach().contiguous(),
        state.contiguous(),
        depth=depth,
        flat=scene.flat_normals,
        no_metal=not scene.has_metal,
    )


def trace_sample(
    scene: Scene,
    camera: Camera,
    seed,
    depth: int = 5,
    include_sky: bool = True,
    use_megakernel: bool | None = None,
) -> torch.Tensor:
    """One path-traced sample per pixel over the full screen [H, W, 3]."""
    return sample_pixels(
        scene, camera, screen_grid(camera), seed, depth, include_sky, use_megakernel
    )


def render_reference(
    scene: Scene,
    camera: Camera,
    accum: RefAccumulator,
    seed,
    depth: int = 5,
    include_sky: bool = True,
    use_megakernel: bool | None = None,
):
    """Accumulating reference render. Returns (image [H, W, 3], accum').
    The keep-or-reset decision stays on the device (no host sync)."""
    sample = trace_sample(scene, camera, seed, depth, include_sky, use_megakernel)
    keep = torch.all(torch.abs(accum.projection_view - camera.projection_view) <= 0.0025)
    keep_f = keep.to(torch.float32)
    color = accum.color * keep_f + sample
    samples = accum.samples * keep_f + 1.0
    image = color / torch.clamp(samples, min=1.0)[..., None]
    return image, RefAccumulator(
        color=color, samples=samples, projection_view=camera.projection_view
    )
