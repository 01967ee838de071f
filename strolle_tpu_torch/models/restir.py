"""The realtime ReSTIR frame (port of strolle_tpu/models/restir.py).

One ``render_frame`` call threads a RenderState (previous surface and
camera, reservoir history, denoiser state, frame counter) through the
stages:

    prelude   primary_pass (ray-cast G-buffer + velocity), the
              reprojection map, miss-pixel sky, blue noise
    history   one gather of the DI/GI history at the reprojected pixels
    DI        sampling -> temporal -> spatial -> resolving
    GI        reprojection -> sampling -> temporal -> spatial ->
              preview x2 -> resolve
    denoise   SVGF on the DI- and GI-diffuse channels
    compose

The stage functions keep the JAX package's names and arguments (less
the device mesh), so a test can feed both packages the same inputs stage
by stage. The frame
counter is a Python int: the GI schedule is decided on the host and no
frame reads a tensor back to pick its passes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera import Camera, pixel_rays, screen_grid
from ..config import DEFAULT_TUNING, Tuning
from ..denoise.svgf import DenoiserState, denoise_pair
from ..device import resolve_device
from ..ops import bluenoise, gather, rng
from ..ops.hit import Surface
from ..restir import di as di_mod
from ..restir import gi as gi_mod
from ..restir.gi import GiReservoirs
from ..restir.primary import Reprojection, build_reprojection_map, primary_pass
from ..restir.reservoir import DiReservoirs
from ..scene.types import Scene
from ..sky.atmosphere import luts_for, sample_atmosphere, sample_sky, sun_direction


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static pipeline configuration: DI + GI + SVGF (the JAX package's
    defaults; its ``mode``, ``denoise``, ``needs_di`` and ``needs_gi``
    switches are not ported)."""

    #: evaluate the atmosphere for miss pixels
    include_sky: bool = False
    #: take trace_closest + surface_at (use_pallas=False), the route
    #: gradients flow through, instead of the fused surface kernel
    differentiable: bool = False
    tuning: Tuning = DEFAULT_TUNING


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Temporal state carried from frame to frame."""

    frame: int
    prev_camera: Camera
    prev_surface: Surface  # [H, W]
    di_prev: DiReservoirs  # resolved DI reservoirs
    gi_prev: GiReservoirs  # GI history (the spatial-or-temporal source)
    di_diff_denoiser: DenoiserState
    gi_diff_denoiser: DenoiserState


def init_state(camera: Camera, device=None) -> RenderState:
    """The state before the first frame: on the CUDA card unless
    ``device`` says otherwise (without a card, ``device="cpu"`` is
    required)."""
    device = resolve_device(device)
    shape = (camera.height, camera.width)
    return RenderState(
        frame=0,
        prev_camera=camera,
        prev_surface=Surface.empty(shape, device),
        di_prev=DiReservoirs.empty(shape, device),
        gi_prev=GiReservoirs.empty(shape, device),
        di_diff_denoiser=DenoiserState.empty(shape, device),
        gi_diff_denoiser=DenoiserState.empty(shape, device),
    )


def derive_seed(seed: int, k: int) -> int:
    """Per-pass seed: one PCG state step of seed + k-th golden-ratio mix
    (host integers, the same u32 value as the JAX package's)."""
    mix = (0x9E3779B9 * (k + 1)) & rng.MASK32
    s = (int(seed) + mix) & rng.MASK32
    return (s * 747796405 + 2891336453) & rng.MASK32


def render_frame(scene: Scene, camera: Camera, state: RenderState, seed: int,
                 config: RenderConfig = RenderConfig(), luts=None):
    """Renders one frame; returns (channels dict, new state). ``luts``
    default to the sun-altitude-keyed cache (``luts_for``), which GI
    samples for its miss rays even with the sky off."""
    if luts is None:
        luts = luts_for(scene.sun_altitude, camera.device)
    use_pallas = False if config.differentiable else None
    frame = int(state.frame)
    seed = int(seed)
    surf, reproj, sky, bn_first, bn_second = _stage_prelude(
        scene, camera, state.prev_camera, state.prev_surface, frame, luts, config.include_sky,
        use_pallas,
    )
    di_rhs, gi_rep, rhs_surf = _stage_history(
        camera, reproj, state.di_prev, state.gi_prev, state.prev_surface
    )
    di_diff, di_spec, di_prev = _stage_di(
        scene, camera, surf, state.prev_surface, reproj, state.di_prev, seed, frame,
        bn_first, sky, config.tuning, use_pallas, (di_rhs, rhs_surf),
    )
    gi_diff, gi_spec, gi_prev = _stage_gi(
        scene, camera, surf, state.prev_surface, reproj, state.gi_prev, seed, frame,
        bn_second, luts, use_pallas, config.tuning, (gi_rep, rhs_surf),
    )
    (di_rgb, di_den), (gi_rgb, gi_den) = _stage_denoise_pair(
        di_diff, gi_diff, surf, reproj, state.di_diff_denoiser, state.gi_diff_denoiser, frame,
        config.tuning,
    )
    channels = _stage_compose(surf, di_rgb, gi_rgb, di_spec, gi_spec)
    new_state = RenderState(
        frame=frame + 1, prev_camera=camera, prev_surface=surf, di_prev=di_prev,
        gi_prev=gi_prev, di_diff_denoiser=di_den, gi_diff_denoiser=gi_den,
    )
    return channels, new_state


def render_frame_fused(scene, camera, state, seed, config=RenderConfig(), luts=None):
    """The JAX package's one-program frame. Eager PyTorch has no program
    to fuse, so this is ``render_frame``."""
    return render_frame(scene, camera, state, seed, config, luts)


def _stage_prelude(scene, camera, prev_camera, prev_surface, frame, luts=None,
                   include_sky=False, use_pallas=None):
    """G-buffer + reprojection map + miss-pixel sky (through ``luts`` when
    given, else the analytic march; zero with the sky off) + blue noise."""
    h, w = camera.height, camera.width
    dev = camera.device
    surf, velocity = primary_pass(scene, camera, prev_camera, use_pallas)
    reproj = build_reprojection_map(camera, surf, prev_surface, velocity)
    if include_sky:
        sun = sun_direction(scene.sun_azimuth, scene.sun_altitude, device=dev)
        _, prim_d = pixel_rays(camera, screen_grid(camera))
        sky = sample_atmosphere(luts, sun, prim_d) if luts is not None else sample_sky(sun, prim_d)
    else:
        sky = torch.zeros((h, w, 3), device=dev)
    bn1x, bn1y, bn2x, bn2y = bluenoise.sample_pair_screen(h, w, frame, dev)
    return (surf, reproj, sky, torch.stack([bn1x, bn1y], -1), torch.stack([bn2x, bn2y], -1))


def _stage_history(camera, reproj, di_prev, gi_prev, prev_surface):
    """One gather at the reprojected coords serves DI temporal, GI
    reprojection and the previous-surface taps."""
    rpx, rpy = reproj.prev_xy_round
    rx = torch.clamp(rpx, 0, camera.width - 1)
    ry = torch.clamp(rpy, 0, camera.height - 1)
    return gather.gather_tree((di_prev, gi_prev, prev_surface), ry, rx)


def _stage_di(scene, camera, surf, prev_surface, reproj, di_prev, seed, frame, bn_first, sky,
              tuning=DEFAULT_TUNING, use_pallas=None, prefetched=None):
    """The four DI passes. ``use_pallas`` is the JAX signature's: the
    port's DI traces only occlusion rays, always through kernel B."""
    a = di_mod.di_sampling(scene, camera, surf, derive_seed(seed, 0), bn_first, tuning)
    b = di_mod.di_temporal(scene, camera, surf, prev_surface, reproj, a, di_prev,
                           derive_seed(seed, 1), tuning, prefetched)
    c = di_mod.di_spatial(scene, camera, surf, b, derive_seed(seed, 2), frame, tuning)
    return di_mod.di_resolving(scene, camera, surf, c, sky)


def _stage_gi(scene, camera, surf, prev_surface, reproj, gi_prev, seed, frame, bn_second,
              luts, use_pallas=None, tuning=DEFAULT_TUNING, prefetched=None):
    return gi_mod.gi_pipeline(scene, camera, surf, prev_surface, reproj, gi_prev, seed, frame,
                              bn_second, luts, use_pallas, tuning, prefetched)


def _stage_denoise_pair(di_samples, gi_samples, surf, reproj, di_state, gi_state, frame,
                        tuning=DEFAULT_TUNING):
    return denoise_pair(di_samples, gi_samples, surf, reproj, di_state, gi_state, frame,
                        tuning=tuning)


def _stage_compose(surf, di_diff_rgb, gi_diff_rgb, di_spec, gi_spec):
    """Emissive + (DI + GI diffuse) x albedo + specular on hits; the DI
    channel (the sky radiance) on misses."""
    albedo = surf.base_color[..., :3]
    image = torch.where(
        surf.is_some[..., None],
        surf.emissive + (di_diff_rgb + gi_diff_rgb) * albedo + di_spec[..., :3] + gi_spec[..., :3],
        di_diff_rgb,
    )
    return {
        "image": image,
        "di_diffuse": di_diff_rgb,
        "di_specular": di_spec[..., :3],
        "gi_diffuse": gi_diff_rgb,
        "gi_specular": gi_spec[..., :3],
        "albedo": albedo,
        "depth": surf.depth,
    }
