"""Brute-force path-traced reference mode (port of
strolle_tpu/models/reference.py).

By default one sample of every pixel is one launch of the megakernel
(ops/kernels/ref_kernel.py) where the scene allows it: no sky, no atlas,
no alpha and at most 1024 triangles. Otherwise, or with
``use_megakernel=False`` or ``use_pallas=False``, the staged loop runs:
per bounce ``trace_surface`` with the caller's ``use_pallas``, the sky
on miss rays, the shading in tensor ops, and a shadow-ray
``trace_anyhit``. With ``use_pallas`` None (the default) the surface
takes the fused route (kernel 4 on a small scene, the strategy's kernel
on a big one), as the JAX package's loop does; ``use_pallas=False``
takes trace_closest + surface_at (kernel A on a small scene), the
forward pass that gradients take.
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
from ..ops.trace import BRUTE_FORCE_MAX_TRIS, check_scene_supported, trace_anyhit, trace_surface
from ..scene.types import Scene
from ..sky.atmosphere import luts_for, sample_atmosphere, sample_sky, sun_direction


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


def megakernel_fits(scene: Scene, include_sky: bool, luts=None) -> bool:
    """The megakernel takes no sky, no atlas, no alpha and at most
    BRUTE_FORCE_MAX_TRIS triangles, as the JAX package's."""
    return (
        not include_sky
        and luts is None
        and scene.atlas is None
        and not scene.has_alpha
        and scene.geometry.num_triangles <= BRUTE_FORCE_MAX_TRIS
    )


def sample_pixels(
    scene: Scene,
    camera: Camera,
    grid: torch.Tensor,  # i32[..., 2] pixel coords
    seed,
    depth: int = 5,
    include_sky: bool = True,
    use_megakernel: bool | None = None,
    luts=None,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """One path-traced sample for each pixel in ``grid``; radiance
    [..., 3]: the sky on miss rays (through ``luts`` when given, else the
    analytic march), emissive + one-light NEE + layered-BRDF
    continuation, with roughness regularised after the first bounce.
    ``use_megakernel``: None takes the megakernel where it fits, True
    requires it, False takes the staged loop. ``use_pallas`` has the JAX
    package's meaning: False takes the staged loop with trace_closest +
    surface_at (the differentiable route); None and True let the
    megakernel run where it fits and pass on to ``trace_surface``."""
    check_scene_supported(scene)
    fits = megakernel_fits(scene, include_sky, luts) and use_pallas is not False
    if use_megakernel and not fits:
        raise ValueError("use_megakernel=True: the megakernel takes no sky, atlas, alpha, "
                         f"scene over {BRUTE_FORCE_MAX_TRIS} triangles or use_pallas=False")
    o, d = pixel_rays(camera, grid)
    state = rng.wnoise_new(seed, grid[..., 0], grid[..., 1])
    if use_megakernel is not False and fits:
        return _sample_pixels_megakernel(scene, o, d, state, depth)

    hw = o.shape[:-1]
    dev = o.device
    color = torch.zeros(hw + (3,), dtype=torch.float32, device=dev)
    throughput = torch.ones(hw + (3,), dtype=torch.float32, device=dev)
    alive = torch.ones(hw, dtype=torch.bool, device=dev)
    lcount = scene.lights.count
    has_lights = lcount > 0
    light_pdf = 1.0 / max(float(lcount), 1.0)

    sun = sun_direction(scene.sun_azimuth, scene.sun_altitude, device=dev)
    for bounce in range(depth + 1):
        surf = trace_surface(scene, o, d, regularize=bounce > 0, use_pallas=use_pallas)

        # the sky on miss rays
        if include_sky:
            missed = alive & ~surf.is_some
            sky = sample_atmosphere(luts, sun, d) if luts is not None else sample_sky(sun, d)
            color = torch.where(missed[..., None], color + throughput * sky, color)
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
    luts=None,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """One path-traced sample per pixel over the full screen [H, W, 3]."""
    return sample_pixels(
        scene, camera, screen_grid(camera), seed, depth, include_sky, use_megakernel, luts,
        use_pallas,
    )


def render_reference(
    scene: Scene,
    camera: Camera,
    accum: RefAccumulator,
    seed,
    depth: int = 5,
    include_sky: bool = True,
    use_megakernel: bool | None = None,
    luts=None,
    use_pallas: bool | None = None,
):
    """Accumulating reference render. Returns (image [H, W, 3], accum').
    With the sky on and no ``luts``, the LUTs of the scene's sun altitude
    come from the host cache (``luts_for``). The keep-or-reset decision
    stays on the device (no host sync)."""
    if include_sky and luts is None:
        luts = luts_for(scene.sun_altitude, camera.device)
    sample = trace_sample(scene, camera, seed, depth, include_sky, use_megakernel, luts,
                          use_pallas)
    keep = torch.all(torch.abs(accum.projection_view - camera.projection_view) <= 0.0025)
    keep_f = keep.to(torch.float32)
    color = accum.color * keep_f + sample
    samples = accum.samples * keep_f + 1.0
    image = color / torch.clamp(samples, min=1.0)[..., None]
    return image, RefAccumulator(
        color=color, samples=samples, projection_view=camera.projection_view
    )
